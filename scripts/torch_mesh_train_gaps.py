"""Read how far the (2, 2) gloo training run lies from its two references.

Runs ``tests/test_torch_mesh.py``'s sharded training (the SmolLM smoke
config in float32, 3 steps of 16 x 32 on four gloo ranks of the CPU), the
port's one-rank run and the JAX reference's ``train(mesh=)`` on four fake
XLA devices, and prints the largest relative loss gap and the largest
per-leaf relative Frobenius gap of the first step's gradients against
each; the tests gate both at 1e-5.

Usage:
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_mesh_train_gaps.py
"""
from __future__ import annotations

import pickle
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import tests.test_torch_mesh as t  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def gaps(got, losses, grads):
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], losses))
    grad = max(t._rel(a, b) for a, b in zip(t.tree_leaves(got["grads"]),
                                            t.tree_leaves(grads)))
    return loss, grad


def main():
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        got = torch.load(t.run_ranks(t.SHARDED_TRAIN, 4, tmp) / "mesh.pt")
        ref = tmp / "ref.pkl"
        t.check("import sys\nsys.argv[1:] = [" + repr(str(ref)) + "]\n"
                + t.REF_SHARDED_TRAIN, n_devices=4)
        with open(ref, "rb") as f:
            want = pickle.load(f)
    cfg = t._smoke()
    tcfg = TrainConfig(**t.TCFG)
    _, _, one = T.train(cfg, tcfg, batch=t.SHAPE[0], seq=t.SHAPE[1],
                        steps=3, device="cpu", log_every=0)
    params, _ = T.init_train_state(cfg, tcfg, "cpu")
    g1, _ = S.loss_grads(params, t._batch(cfg), cfg)
    print("(2, 2) gloo against the one-rank run: loss %.3g, gradients %.3g"
          % gaps(got, one, g1))
    gr = M.params_from_numpy(want["grads"], cfg, device="cpu")
    print("(2, 2) gloo against the reference's (2, 2) mesh: loss %.3g, "
          "gradients %.3g" % gaps(got, want["losses"], gr))


if __name__ == "__main__":
    main()
