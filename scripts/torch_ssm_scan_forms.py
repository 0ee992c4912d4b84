"""Zamba2-1.2B's chunked scan in two forms, on one NVIDIA GPU: the port's
(``models/ssm.py``: the decay between two positions of a chunk summed over
its own segment) and the reference's (the same decay as a difference of
two inclusive cumsums over the chunk, copied below).

At full width and depth (random bf16 weights from the keyed init, seed 0)
it prints for each form, in turns (port, reference, reference, port):

- the open forward's time at ``FORWARD_SHAPE`` (CUDA-synchronized host
  time, median of ``REPS``), and one train step's gradient
  (``launch/steps.py:loss_grads``) at ``TRAIN_SHAPE``;
- with float32 weights and TF32 off, at ``GRAD_SHAPE``: the largest
  relative Frobenius gap, over the gradient's leaves, between the flash
  kernels and the plain attention (``chip_smoke.py``'s float32 gradient
  gate, bound 1e-4), with its leaf.

    python3 scripts/torch_ssm_scan_forms.py
"""
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

ARCH, SEED = "zamba2_1_2b", 0
FORWARD_SHAPE = (4, 1024)       # chip_smoke.py's zamba2 infer
TRAIN_SHAPE = (8, 1024)         # its train step
GRAD_SHAPE = (2, 1024)          # its float32 gradient gate
REPS = 3
f32 = torch.float32


def cumsum_difference(q, k, v, log_a, b, *, chunk, init_state=None,
                      normalize=False, den_floor=None):
    """The reference's form (``repro/models/ssm.py``): exp(La_t - La_s)
    with La the chunk's inclusive cumsum."""
    B, Sq, H, dk = q.shape
    dv = v.shape[-1]
    Lc = min(chunk, Sq)
    nc = Sq // Lc
    qc = q.to(f32).reshape(B, nc, Lc, H, dk)
    kc = k.to(f32).reshape(B, nc, Lc, H, dk)
    vc = v.to(f32).reshape(B, nc, Lc, H, dv)
    bc = b.to(f32).reshape(B, nc, Lc, H)
    La = torch.cumsum(log_a.to(f32).reshape(B, nc, Lc, H), dim=2)
    C = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
    n = torch.zeros((B, H, dk), dtype=f32, device=q.device)
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=q.device))
    ys = []
    for c in range(nc):
        qb, kb, vb, Lab, bb = qc[:, c], kc[:, c], vc[:, c], La[:, c], bc[:, c]
        qk = torch.einsum("bthd,bshd->bhts", qb, kb)
        ldiff = (Lab[:, :, None, :] - Lab[:, None, :, :]).masked_fill(
            ~tri[None, :, :, None], float("-inf"))
        decay = torch.exp(ldiff).permute(0, 3, 1, 2)
        scores = qk * decay * bb.permute(0, 2, 1)[:, :, None, :]
        y = torch.einsum("bhts,bshd->bthd", scores, vb)
        y = y + torch.einsum("bthd,bhde->bthe", qb, C) * torch.exp(
            Lab)[..., None]
        kw = kb * (torch.exp(Lab[:, -1:, :] - Lab) * bb)[..., None]
        C = (C * torch.exp(Lab[:, -1])[..., None, None]
             + torch.einsum("bshd,bshe->bhde", kw, vb))
        n = n * torch.exp(Lab[:, -1]).reshape(B, H, 1) + torch.sum(kw, dim=1)
        ys.append(y)
    assert not normalize            # Mamba2's use
    return torch.stack(ys, dim=1).reshape(B, Sq, H, dv), (C, n)


FORMS = {"segment sums (port)": ssm.chunked_linear_recurrence,
         "cumsum difference (reference)": cumsum_difference}


def _batch(cfg, shape, dev):
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, shape[1], shape[0],
                                    seed=SEED))
    return {"tokens": torch.from_numpy(pipe.batch(0)["tokens"]).to(dev)}


def _ms(fn):
    out = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def _named(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _grad_gap(cfg, params32, batch):
    """(largest relative Frobenius gap of the kernels' gradient from the
    plain attention's, its leaf)."""
    f32cfg = cfg.replace(dtype="float32")
    got = S.loss_grads(params32, batch, f32cfg)[0]
    saved = (A.flash_attention_fwd, A.flash_attention_bwd)
    A.flash_attention_fwd = flash_attention_plain
    A.flash_attention_bwd = flash_attention_bwd_plain
    try:
        want = dict(_named(S.loss_grads(params32, batch, f32cfg)[0]))
    finally:
        A.flash_attention_fwd, A.flash_attention_bwd = saved
    gaps = {k: ((g.float() - want[k].float()).norm()
                / want[k].float().norm()).item() for k, g in _named(got)}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_ssm_scan_forms: CUDA is not available")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    key = prng.PRNGKey(SEED)
    params = L.init_params_keyed(key, M.model_defs(cfg), torch.bfloat16,
                                 device=dev)
    params32 = L.init_params_keyed(
        key, M.model_defs(cfg.replace(dtype="float32")), f32, device=dev)
    fwd, train, grad = (_batch(cfg, s, dev) for s in (FORWARD_SHAPE,
                                                      TRAIN_SHAPE,
                                                      GRAD_SHAPE))
    print(torch.cuda.get_device_name(0), f"{len(tree_leaves(params))} "
          f"leaves; forward {FORWARD_SHAPE}, train step {TRAIN_SHAPE}, "
          f"float32 gradients {GRAD_SHAPE}")
    names = list(FORMS)
    for name in names + names[::-1]:
        ssm.chunked_linear_recurrence = FORMS[name]
        with torch.no_grad():
            fwd_ms = _ms(lambda: M.forward(params, fwd, cfg))
        grad_ms = _ms(lambda: S.loss_grads(params, train, cfg))
        gap, leaf = _grad_gap(cfg, params32, grad)
        print(f"{name}: open forward {fwd_ms:.2f} ms, a train step's "
              f"gradient {grad_ms:.2f} ms (medians of {REPS}); float32 "
              f"gradients, kernels against the plain attention: {gap:.3g} "
              f"at {leaf}", flush=True)
    ssm.chunked_linear_recurrence = FORMS[names[0]]


if __name__ == "__main__":
    main()
