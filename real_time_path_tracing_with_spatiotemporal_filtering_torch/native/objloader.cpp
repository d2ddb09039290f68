// Native OBJ loader: the host-side scene-ingestion fast path.
//
// Plays the role tinyobjloader plays in the reference (main.cpp:409-462):
// parse vertices and faces, fan-triangulate n-gons in tinyobj's order
// ((0, i, i+1) for i in 1..n-2) so primitive IDs line up with the Python
// loader (scene/obj.py load_obj_python), which is the parity oracle for
// this code. The JAX package's native/objloader.cpp, line for line.
//
// Exposed as a C ABI for ctypes; native/loader.py builds it with g++ at
// first use.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Mesh {
  std::vector<float> vertices;   // xyz triples
  std::vector<int32_t> indices;  // triangle index triples
};

// Parse one face token ("v", "v/vt", "v//vn", "v/vt/vn"); 1-based,
// negative = relative to current vertex count.
bool parse_face_token(const char* tok, size_t num_vertices, int32_t* out) {
  char* end = nullptr;
  long idx = std::strtol(tok, &end, 10);
  if (end == tok) return false;
  if (idx < 0) {
    idx = static_cast<long>(num_vertices) + idx;
  } else {
    idx -= 1;
  }
  if (idx < 0 || static_cast<size_t>(idx) >= num_vertices) return false;
  *out = static_cast<int32_t>(idx);
  return true;
}

Mesh* load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::string data;
  char buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) data.append(buf, n);
  std::fclose(f);

  auto mesh = new Mesh();
  std::vector<int32_t> corners;
  size_t pos = 0;
  const size_t len = data.size();
  while (pos < len) {
    size_t eol = data.find('\n', pos);
    if (eol == std::string::npos) eol = len;
    std::string line = data.substr(pos, eol - pos);
    pos = eol + 1;
    // strip leading whitespace
    size_t s = line.find_first_not_of(" \t\r");
    if (s == std::string::npos) continue;
    if (line[s] == '#') continue;

    if (line.compare(s, 2, "v ") == 0) {
      float x, y, z;
      if (std::sscanf(line.c_str() + s + 1, "%f %f %f", &x, &y, &z) == 3) {
        mesh->vertices.push_back(x);
        mesh->vertices.push_back(y);
        mesh->vertices.push_back(z);
      }
    } else if (line.compare(s, 2, "f ") == 0) {
      corners.clear();
      const char* p = line.c_str() + s + 1;
      while (*p) {
        while (*p == ' ' || *p == '\t') ++p;
        if (!*p) break;
        int32_t idx;
        if (!parse_face_token(p, mesh->vertices.size() / 3, &idx)) {
          delete mesh;
          return nullptr;
        }
        corners.push_back(idx);
        while (*p && *p != ' ' && *p != '\t') ++p;
      }
      for (size_t i = 1; i + 1 < corners.size(); ++i) {
        mesh->indices.push_back(corners[0]);
        mesh->indices.push_back(corners[i]);
        mesh->indices.push_back(corners[i + 1]);
      }
    }
  }
  return mesh;
}

}  // namespace

extern "C" {

void* ptsf_load_obj(const char* path) { return load(path); }

void ptsf_mesh_counts(void* handle, int64_t* num_vertices, int64_t* num_triangles) {
  auto* mesh = static_cast<Mesh*>(handle);
  *num_vertices = static_cast<int64_t>(mesh->vertices.size() / 3);
  *num_triangles = static_cast<int64_t>(mesh->indices.size() / 3);
}

void ptsf_mesh_copy(void* handle, float* vertices_out, int32_t* indices_out) {
  auto* mesh = static_cast<Mesh*>(handle);
  std::memcpy(vertices_out, mesh->vertices.data(),
              mesh->vertices.size() * sizeof(float));
  std::memcpy(indices_out, mesh->indices.data(),
              mesh->indices.size() * sizeof(int32_t));
}

void ptsf_mesh_free(void* handle) { delete static_cast<Mesh*>(handle); }

}  // extern "C"
