"""Routing of Qwen3-MoE-235B-A22B under the blinded tier-1 against the float
forward, on one NVIDIA GPU.

The tier-1 ops quantize their activations to 8 bits, so the router of a
MoE block sees a slightly different input on the blinded path than on
the float ("split" plan) path, and a top-8 choice whose 8th and 9th
experts lie close flips. This script measures how often, at full width
(6 of the config's 94 blocks, random bf16 weights from seed 0, p = 4):
for the LM forward at each batch shape of ``SHAPES`` and for one tiered
decode step of ``STEP_ROWS`` tokens at position 0, block by block, it
prints how many experts each row keeps (a histogram over all rows and
over the rows routed alike in every earlier block), the router logits'
rel err (max |dz| / max |z|) on those rows, the largest |dz|, the median
gap between the float path's 8th and 9th logits, and the rows routed
alike everywhere with the output's rel err on them and on all rows.

    python3 scripts/torch_moe_routing.py
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.blinding import BlindingSpec  # noqa: E402
from repro_torch.core.integrity import IntegrityPolicy  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.core.prng import PRNGKey  # noqa: E402
from repro_torch.core.slalom import SlalomContext  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.runtime.generate import tiered_decode_step  # noqa: E402

BLOCKS, SEED = 6, 0
# (batch, tokens): chip_smoke's moe infer batch (groups of 128 tokens,
# capacity 10: drops), groups of 8 tokens at capacity 8 (no drops), and
# groups of 32 at capacity 2 (many drops)
SHAPES = ((4, 1024), (2, 128), (16, 64))
STEP_ROWS = (64, 256)


class Routes:
    """Router logits and experts of every ``moe._route`` call while
    entered, one a block, in call order."""

    def __init__(self):
        self.inner, self.logits, self.experts = moe._route, [], []

    def __call__(self, p, x, cfg):
        w, e, aux = self.inner(p, x, cfg)
        self.logits.append((x.float() @ p["router"]["w"])
                           .reshape(-1, cfg.moe.num_experts))
        self.experts.append(e.reshape(-1, e.shape[-1]))
        return w, e, aux

    def __enter__(self):
        moe._route = self
        return self

    def __exit__(self, *exc):
        moe._route = self.inner


def rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()


def compare(a, b, blocks, where):
    """Per block: experts kept, router logits' error on the rows routed
    alike so far; returns the rows routed alike in all ``blocks``."""
    alike = torch.ones(a.experts[0].shape[0], dtype=torch.bool,
                       device=a.experts[0].device)
    for i in range(blocks):
        ea, eb, za, zb = a.experts[i], b.experts[i], a.logits[i], b.logits[i]
        k = ea.shape[-1]
        kept = (ea[:, :, None] == eb[:, None, :]).any(-1).sum(-1)
        top = torch.sort(zb, dim=-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]).median().item()
        dz = (za - zb)[alike].abs().max().item() if alike.any() else None
        print(f"{where} block {i + 1}: experts kept, all rows "
              f"{torch.bincount(kept, minlength=k + 1).tolist()}, the "
              f"{int(alike.sum())} rows alike so far "
              f"{torch.bincount(kept[alike], minlength=k + 1).tolist()}; "
              f"router logits rel err on them "
              f"{rel(za[alike], zb[alike]) if alike.any() else None}, max "
              f"|dz| {dz}; max |z| {zb.abs().max().item():.4f}; median gap "
              f"8th-9th {gap:.4f}")
        alike &= kept == k
    print(f"{where}: {int(alike.sum())} of {alike.numel()} rows routed "
          f"alike in every block")
    return alike


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_moe_routing: CUDA is not available")
    dev = torch.device("cuda")
    cfg = get_config("qwen3_moe_235b").replace(num_layers=BLOCKS)
    p = cfg.origami.tier1_layers
    params = M.init_params(cfg, SEED, device=dev)
    ex = OrigamiExecutor(cfg, params, "origami", p,
                         integrity=IntegrityPolicy.full(k=2), device=dev)
    split = OrigamiExecutor(cfg, params, "split", p, device=dev)
    for i, shape in enumerate(SHAPES):
        tokens = torch.from_numpy(np.random.default_rng(SEED + 60 + i)
                                  .integers(0, cfg.vocab_size, shape)).to(dev)
        with Routes() as blinded:
            got = ex.infer({"tokens": tokens}, PRNGKey(SEED + 61)).boundary
        with Routes() as plain:
            want = split.infer({"tokens": tokens}).boundary
        alike = compare(blinded, plain, p, f"infer {shape}")
        d = cfg.d_model
        on_alike = (rel(got.reshape(-1, d)[alike], want.reshape(-1, d)[alike])
                    if alike.any() else None)
        print(f"infer {shape}: tier-1 boundary rel err on the rows alike "
              f"{on_alike}, on all {rel(got, want)}")
    for i, n in enumerate(STEP_ROWS):
        token = torch.from_numpy(np.random.default_rng(SEED + 70 + i)
                                 .integers(0, cfg.vocab_size, (n, 1))).to(dev)
        with torch.no_grad():
            with Routes() as plain:
                want, _ = M.decode_step(params, token, M.init_caches(
                    cfg, n, 8, device=dev), 0, cfg)
            with Routes() as blinded:
                got, _ = tiered_decode_step(
                    params, token, M.init_caches(cfg, n, 8, device=dev), 0,
                    cfg, SlalomContext(PRNGKey(7), BlindingSpec()), p)
        alike = compare(blinded, plain, BLOCKS, f"step {n}")
        print(f"step {n}: logits rel err on the rows alike "
              f"{rel(got[alike], want[alike]) if alike.any() else None}, on "
              f"all {rel(got, want)}")


if __name__ == "__main__":
    main()
