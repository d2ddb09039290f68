"""The port's command line (cli_torch.py) and viewer against the JAX
package's: the same run gives the same checkpoint and PNG names, the same
argument errors, and the viewer records its frames."""

import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import cli
import cli_torch
from real_time_path_tracing_with_spatiotemporal_filtering_torch import viewer

torch.set_num_threads(1)

# Golden scale (48x32, 6 bounces, 3 a-trous iterations), a moving light and
# a moving camera.
RUN = ["--width", "48", "--height", "32", "--frames", "3", "--max-bounces", "6",
       "--wavelet-iterations", "3", "--orbit-light", "0.1", "--move-camera", "0.01", "0", "-0.02"]


def _jax_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["cli.py", *argv])
    cli.main()


def test_cli_checkpoint_matches_jax(tmp_path, monkeypatch, capsys):
    outs = {k: str(tmp_path / k) for k in ("jax", "torch")}
    _jax_cli(monkeypatch, RUN + ["--out", outs["jax"], "--checkpoint", outs["jax"] + ".npz"])
    last = cli_torch.main(RUN + ["--out", outs["torch"], "--checkpoint", outs["torch"] + ".npz",
                                 "--device", "cpu"])
    assert "first (kernel build + first frame)" in capsys.readouterr().err
    assert sorted(os.listdir(outs["torch"])) == sorted(os.listdir(outs["jax"])) == [
        f"frame_{i:05d}.png" for i in range(3)]
    with np.load(outs["jax"] + ".npz") as want, np.load(outs["torch"] + ".npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            g, w = got[k], want[k]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        np.testing.assert_array_equal(last.numpy(), got["arr_0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli_torch.main(RUN)


def test_cli_argument_errors_match_jax(monkeypatch, capsys):
    for bad in (["--path-gradient"], ["--indirect-split", "32"]):
        errors = []
        for run in (lambda: _jax_cli(monkeypatch, bad), lambda: cli_torch.main(bad)):
            with pytest.raises(SystemExit) as exc:
                run()
            assert exc.value.code == 2
            errors.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
        assert errors[0] == errors[1] and errors[0].startswith(bad[0])


def test_viewer_headless_records_frames(tmp_path):
    rec = tmp_path / "rec"
    buf = io.StringIO()
    with redirect_stdout(buf):
        viewer.main(["--headless", "--width", "48", "--height", "32", "--frames", "2",
                     "--record", str(rec), "--device", "cpu"])
    assert sorted(os.listdir(rec)) == ["frame_00000.png", "frame_00001.png"]
    assert all((rec / n).read_bytes().startswith(b"\x89PNG") for n in os.listdir(rec))
    out = buf.getvalue()
    assert out.count("\x1b[H\x1b[2J") == 2 and "frame 1 " in out and "▀" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            viewer.main(["--headless", "--frames", "1", "--no-preview"])
