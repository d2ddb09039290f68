"""Exact mid-sequence checkpoint/resume on the card, through the PyTorch
port (a capability the reference lacks: its only restart is relaunching the
app and losing temporal history).

Renders 10 frames, saves, renders 10 more; then reloads the checkpoint in
a fresh renderer and re-renders the same 10 -- bit-identical. Runs on the
CUDA card; ``--device cpu`` runs the plain PyTorch versions instead.

Run:  python examples/checkpoint_resume_torch.py [--device cpu]
"""

import argparse
import tempfile

import torch

import real_time_path_tracing_with_spatiotemporal_filtering_torch as ptt


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    cfg = ptt.RenderConfig(width=320, height=240, max_bounces=8)
    scene = ptt.Scene.cornell_box()

    r = ptt.Renderer(scene, cfg, device=args.device)
    r.render(10)
    with tempfile.NamedTemporaryFile(suffix=".npz") as f:
        r.save_state(f.name)
        a = r.render(10)

        r2 = ptt.Renderer(scene, cfg, device=args.device)
        r2.load_state(f.name)
        b = r2.render(10)

    if not torch.equal(a, b):
        raise SystemExit("resume must be exact")
    print(f"resume bit-identical at frame {r.frame_count}")


if __name__ == "__main__":
    main()
