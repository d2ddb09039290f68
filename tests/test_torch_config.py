"""The PyTorch port's RenderConfig, guards and build flags against the JAX
package."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_tpu.config import (
    RenderConfig as JaxConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline import (
    frame as jframe,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene.scene import (
    Camera as JaxCamera,
    Light as JaxLight,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch import (
    Renderer,
    Scene,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda import _build
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline import frame
from test_torch_estimators import assert_nee_matches

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fields_and_defaults_identical():
    jax_fields = [(f.name, f.type, f.default) for f in dataclasses.fields(JaxConfig)]
    port_fields = [(f.name, f.type, f.default) for f in dataclasses.fields(RenderConfig)]
    assert port_fields == jax_fields
    assert RenderConfig().resolution == JaxConfig().resolution


INVALID = [
    dict(width=0),
    dict(height=-1),
    dict(wavelet_iterations=4),
    dict(spp=0),
    dict(max_bounces=0),
    dict(rr_start_bounce=-1),
    dict(rr_min_prob=0.0),
    dict(rr_min_prob=0.9, rr_max_prob=0.5),
    dict(demodulate_albedo=True),
    dict(accumulation_ramp=True, ramp_alpha_min=0.0),
    dict(ramp_reset_mode="depth"),
    dict(firefly_clamp=-1.0),
    dict(path_gradient=True),
    dict(gradient_stratum=0),
    dict(indirect_split=32),
    dict(indirect_split=2, indirect_stride=0),
    dict(indirect_split=2, indirect_sigma_z=0.0),
    dict(indirect_split=2, indirect_normal_pow=-1),
    dict(indirect_split=2, indirect_jitter=True, width=999),
    dict(indirect_jitter=True),
    dict(backend="cuda"),
]


@pytest.mark.parametrize("kwargs", INVALID, ids=[str(k) for k in INVALID])
def test_invalid_config_rejected_by_both(kwargs):
    with pytest.raises(ValueError):
        JaxConfig(**kwargs)
    with pytest.raises(ValueError):
        RenderConfig(**kwargs)


EXTENSIONS = [
    ("nee", dict(nee=True)),
    ("rr_start_bounce", dict(rr_start_bounce=1)),
    ("truncate_radiance", dict(truncate_radiance=True)),
    ("variance_guided", dict(variance_guided=True)),
    ("demodulate_albedo", dict(variance_guided=True, demodulate_albedo=True)),
    ("accumulation_ramp", dict(accumulation_ramp=True)),
    ("firefly_clamp", dict(firefly_clamp=2.0)),
    ("gbuffer_primary", dict(gbuffer_primary=True)),
    ("gbuffer_primary_nee", dict(gbuffer_primary=True, nee=True)),
    ("path_gradient", dict(adaptive_alpha=True, path_gradient=True)),
    ("indirect_split", dict(indirect_split=2)),
]


@pytest.mark.parametrize("name,kwargs", EXTENSIONS, ids=[n for n, _ in EXTENSIONS])
def test_extension_flag_matches_jax(cornell_tri_data, name, kwargs):
    """Each extension the port used to refuse renders one 16x16 frame on
    the CPU that matches the JAX package's jitted XLA frame (at the golden
    tolerance; NEE at its criterion, tests/test_torch_estimators.py)."""
    cfg = RenderConfig(width=16, height=16, max_bounces=3, wavelet_iterations=1, **kwargs)
    assert getattr(cfg, name.removesuffix("_nee"))
    want, _ = jframe.render_frame(
        cornell_tri_data, JaxCamera.default(), JaxLight.default(),
        jframe.init_history(cornell_tri_data, cfg), cfg,
    )
    got = Renderer(Scene.cornell_box(), cfg, device="cpu").step().numpy()
    if cfg.nee:
        assert_nee_matches(got, want)
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_model_matrix_raises():
    """A model matrix that is neither (4, 4) nor (3, 4) is refused."""
    r = Renderer(Scene.cornell_box(), RenderConfig(width=8, height=8), device="cpu")
    with pytest.raises(ValueError, match="model matrix"):
        frame.render_frame_impl(r.tri_data, r.camera, r.light, r.history, r.cfg,
                                model=torch.eye(3))


def test_pallas_backend_on_cpu_raises():
    r = Renderer(Scene.cornell_box(), RenderConfig(width=8, height=8, backend="pallas"),
                 device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        r.step()


def test_port_does_not_import_jax():
    code = (
        "import sys\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch as p\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda.atrous\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda.geometry\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda.micro\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda.pathtrace\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.cuda.wavefront\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.multires\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.ops.pathgrad\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.lbvh\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.suite\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.mosaic_micro\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.profiling\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.quality\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.native.loader\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.input\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.obj\n"
        "import real_time_path_tracing_with_spatiotemporal_filtering_torch.viewer\n"
        "import bench_torch\n"
        "import cli_torch\n"
        "from real_time_path_tracing_with_spatiotemporal_filtering_torch.models import presets\n"
        "p.Renderer(p.Scene.cornell_box(), p.RenderConfig(width=8, height=8, max_bounces=2),"
        " device='cpu').step()\n"
        "presets.cornell_box_quality(device='cpu', width=8, height=8, max_bounces=2).step()\n"
        "presets.cornell_stress(splits=4, device='cpu', width=8, height=8, max_bounces=2,"
        " gbuffer_primary=True, nee=True).step()\n"
        "presets.cornell_stress(splits=4, device='cpu', width=8, height=8, max_bounces=2,"
        " adaptive_alpha=True, path_gradient=True, indirect_split=1).step()\n"
        "cli_torch.main(['--device', 'cpu', '--width', '8', '--height', '8', '--frames', '1',"
        " '--max-bounces', '2'])\n"
        "real_time_path_tracing_with_spatiotemporal_filtering_torch.benchmarks.quality.run("
        "8, 1, 1, max_bounces=2, device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('real_time_path_tracing_with_spatiotemporal_filtering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_nvcc_flags():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--use_fast_math" not in flags
    assert "-ftz=true" not in flags
    assert "--fmad=false" in flags
    assert {os.path.basename(s) for s in _build.sources()} == {
        "geometry.cu", "pathtrace.cu", "atrous.cu", "wavefront.cu", "micro.cu", "model.cu"
    }


def _c_entry_points(source: str) -> dict:
    """The argument types of each ``extern "C"`` entry point of ``source``,
    read from its definition: pointers and the stream as c_void_p, int as
    c_int, float as c_float."""
    import ctypes
    import re

    with open(source) as f:
        text = f.read()
    out = {}
    for m in re.finditer(r'extern "C" int (ptsf_\w+)\(([^)]*)\)', text):
        kinds = []
        for param in m.group(2).split(","):
            words = param.split()
            if "*" in param or words[0] == "cudaStream_t":
                kinds.append(ctypes.c_void_p)
            else:
                kinds.append({"int": ctypes.c_int, "float": ctypes.c_float}[words[0]])
        out[m.group(1)] = kinds
    return out


@pytest.mark.parametrize("source", sorted(os.path.basename(s) for s in _build.sources()))
def test_c_entry_points_declared(source):
    """The ctypes declaration of every C entry point in a kernel source
    matches its definition, argument for argument (a mismatch shows only as
    a wrong launch on the card)."""
    path = next(s for s in _build.sources() if os.path.basename(s) == source)
    defined = _c_entry_points(path)
    assert defined, f"{source} defines no entry point"
    declared = _build.signatures()
    for name, kinds in defined.items():
        assert declared.get(name) == kinds, name


def test_every_declared_entry_point_is_defined():
    defined = {}
    for source in _build.sources():
        defined.update(_c_entry_points(source))
    assert set(_build.signatures()) == set(defined)


def test_cpu_launches_nothing():
    """On CPU tensors the wrappers run the plain version and count no
    launch."""
    _build.LAUNCHES.clear()
    r = Renderer(Scene.cornell_box(), RenderConfig(width=8, height=8, max_bounces=2),
                 device="cpu")
    frame._render_frame_kernels(r.tri_data, r.camera, r.light, r.history, r.cfg)
    assert sum(_build.LAUNCHES.values()) == 0


def test_renderer_without_device_needs_a_card():
    """The entry points run on the card unless the caller asks for the
    CPU: with no CUDA device, device=None raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = RenderConfig(width=8, height=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(Scene.cornell_box(), cfg, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(Scene.cornell_box(), cfg)
