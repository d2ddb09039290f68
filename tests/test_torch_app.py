"""The port's app leaves against the JAX package's: the key bindings
(pipeline/input.py), the OBJ writer and soup, the native and Python OBJ
loaders, and the viewer's preview and config."""

import argparse
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from real_time_path_tracing_with_spatiotemporal_filtering_torch import viewer
from real_time_path_tracing_with_spatiotemporal_filtering_torch.config import RenderConfig
from real_time_path_tracing_with_spatiotemporal_filtering_torch.native import loader
from real_time_path_tracing_with_spatiotemporal_filtering_torch.pipeline.input import apply_keys
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene import obj, procedural
from real_time_path_tracing_with_spatiotemporal_filtering_torch.scene.scene import (
    Camera,
    Light,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu import viewer as jviewer
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.config import (
    RenderConfig as JRenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.pipeline.input import (
    apply_keys as japply_keys,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene import (
    obj as jobj,
    procedural as jproc,
)
from real_time_path_tracing_with_spatiotemporal_filtering_tpu.scene.scene import (
    Camera as JCamera,
    Light as JLight,
)

torch.set_num_threads(1)

# (key set, light position or None for the default) -- the cases of
# tests/test_input_and_utils.py:29-75, then every binding alone.
KEY_CASES = [
    ({"w"}, None), ({"d", "e", "s"}, None), ({"i"}, None),
    ({"a", "d", "w", "s"}, None),
    ({"l"}, None), ({"l"}, [1.95, 1.0, -0.4]), ({"j"}, [-19.95, 1.0, -0.4]),
    # the wrap is taken only in the direction of travel
    ({"j"}, [2.5, 1.0, -0.4]), ({"l"}, [-20.5, 1.0, -0.4]),
    ({"L", "O", "K"}, [1.95, 1.0, -0.4]), (set(), None),
] + [({k}, None) for k in "wasdqeijkluo"]


def test_apply_keys_matches_jax_bit_for_bit():
    cfg, jcfg = RenderConfig(), JRenderConfig()
    for keys, light_pos in KEY_CASES:
        jcam, jlight = JCamera.default(), JLight.default()
        if light_pos is not None:
            jlight = dataclasses.replace(jlight, position=np.float32(light_pos))
        cam = Camera(position=torch.tensor(np.asarray(jcam.position)),
                     rotation=torch.tensor(np.asarray(jcam.rotation)))
        light = Light(position=torch.tensor(np.asarray(jlight.position)),
                      color=torch.tensor(np.asarray(jlight.color)))
        want = japply_keys(jcam, jlight, keys, jcfg)
        got = apply_keys(cam, light, keys, cfg)
        assert got[2] == want[2], keys
        for g, w in ((got[0].position, want[0].position), (got[0].rotation, want[0].rotation),
                     (got[1].position, want[1].position), (got[1].color, want[1].color)):
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(keys))


def test_write_obj_bytes_and_random_soup(tmp_path):
    for name, (verts, idx) in (("cornell", procedural.cornell_box()),
                               ("soup", procedural.random_soup(300, seed=7)),
                               ("sub", procedural.subdivided_cornell(3))):
        procedural.write_obj(str(tmp_path / f"{name}.obj"), verts, idx)
        jproc.write_obj(str(tmp_path / f"{name}_jax.obj"), verts, idx)
        assert (tmp_path / f"{name}.obj").read_bytes() == (tmp_path / f"{name}_jax.obj").read_bytes()
    for args in ((5000, 3), (17, 0, 2.0, 0.2)):
        for got, want in zip(procedural.random_soup(*args), jproc.random_soup(*args)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_native_and_python_loaders_agree_with_jax(tmp_path, monkeypatch):
    """The cases of tests/test_native.py:37-107 on the native loader, the
    port's and the JAX package's Python parsers, and load_obj; the library
    is built in the port's _build/; a bad index, a failed build and a
    missing compiler raise."""
    sources = {
        "quads": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\nf -4 -3 -2\n",
        "slashes": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvn 0 0 1\n"
                    "f 1/1 2/1 3/1\nf 1//1 2//1 3//1\nf 1/1/1 2/1/1 3/1/1\n"),
    }
    for name, text in sources.items():
        (tmp_path / f"{name}.obj").write_text(text)
    procedural.write_obj(str(tmp_path / "cornell.obj"), *procedural.cornell_box())
    procedural.write_obj(str(tmp_path / "soup.obj"), *procedural.random_soup(5000, seed=3))
    for name in ("cornell", "quads", "slashes", "soup"):
        path = str(tmp_path / f"{name}.obj")
        want = jobj.load_obj_python(path)
        for got in (loader.load_obj(path), obj.load_obj_python(path), obj.load_obj(path)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w, err_msg=name)
    assert obj.load_obj_python(str(tmp_path / "quads.obj"))[1].shape == (3, 3)
    assert loader.library_path().startswith(loader.BUILD_DIR)
    assert "real_time_path_tracing_with_spatiotemporal_filtering_torch" in loader.BUILD_DIR

    bad = str(tmp_path / "bad.obj")
    (tmp_path / "bad.obj").write_text("v 0 0 0\nf 1 2 3\n")
    for load in (loader.load_obj, obj.load_obj_python, obj.load_obj, jobj.load_obj_python):
        with pytest.raises(ValueError):
            load(bad)

    verts, idx = procedural.subdivided_cornell(2)
    for got, want in zip(obj.deduplicate_positions(verts, idx),
                         jobj.deduplicate_positions(verts, idx)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SOURCE", str(broken))
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        loader.build()
    assert not list((tmp_path / "_build").iterdir())
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        loader.build()


def _namespace(**over):
    args = dict(width=40, height=24, nee=False, rr_start_bounce=0, ramp=False,
                path_gradient=False)
    args.update(over)
    return argparse.Namespace(**args)


def test_ansi_preview_and_build_config_match_jax(capsys):
    img = np.random.default_rng(11).uniform(-0.2, 1.3, (37, 53, 3)).astype(np.float32)
    for cols, rows in ((100, 40), (20, 7), (53, 19)):
        assert viewer.ansi_preview(img, cols, rows) == jviewer.ansi_preview(img, cols, rows)
    for ns in (_namespace(), _namespace(ramp=True, nee=True), _namespace(path_gradient=True),
               _namespace(rr_start_bounce=3, indirect_split=1, indirect_stride=4,
                          indirect_jitter=True, gbuffer_primary=True, firefly_clamp=2.0)):
        got, want = viewer.build_config(ns), jviewer.build_config(ns)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert capsys.readouterr().err.count("--path-gradient implies --ramp") == 2
