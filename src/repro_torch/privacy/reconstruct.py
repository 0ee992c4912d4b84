"""Adversary training loop + the paper's partition search (Algorithm 1).

Port of ``repro/privacy/reconstruct.py``. ``train_adversary`` trains the
c-GAN on (Θ(X), X) pairs collected from a partition layer;
``partition_search`` walks the layers exactly as Algorithm 1: find the
first layer p whose SSIM is below threshold, then verify p+1 and p+2 (the
paper's non-monotonicity guard — max-pool outputs can be safe while the
*next conv* is reconstructable again).

``token_recovery_probe`` is the LM-family analogue: a linear probe
recovering input token identity from boundary hidden states; recovery
accuracy plays the role of SSIM.

The reference jits its training step; here each step runs eagerly, its
gradients from autograd and its update from optim/adamw.py. The same seed
gives the reference's initial adversary (``init_params_keyed``) and the
probe's tokens (``prng.randint``). Entry points run on the card unless the
caller passes ``device="cpu"``; on the card TF32 stays off and the
adversary's run repeats bit for bit (cuDNN's deterministic algorithms,
upsampling without atomics), as the CPU's does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import prng
from repro_torch.core.origami import params_to_device, resolve_device
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import layers as L
from repro_torch.models import vgg as V
from repro_torch.optim import adamw
from repro_torch.privacy import cgan
from repro_torch.privacy.data import make_batch
from repro_torch.privacy.ssim import ssim


@dataclasses.dataclass
class AdversaryReport:
    layer: int
    ssim: float
    g_loss: float
    d_loss: float
    steps: int
    # mean milliseconds a training step spends collecting Θ(X) and in the
    # D+G update (CUDA events on the card, the host clock on the CPU)
    collect_ms: float = 0.0
    step_ms: float = 0.0


def _images(start: int, n: int, size: int, device,
            cache: Optional[dict] = None) -> torch.Tensor:
    """``make_batch(start, n, size)`` on ``device``; with ``cache``, each
    batch is drawn once and kept there."""
    if cache is None:
        return torch.from_numpy(make_batch(start, n, size)).to(device)
    key = (start, n, size, str(device))
    if key not in cache:
        cache[key] = _images(start, n, size, device)
    return cache[key]


@torch.no_grad()
def collect_features(params, images: torch.Tensor, cfg: ModelConfig,
                     layer: int) -> torch.Tensor:
    """Θ(X): feature maps after ``layer`` (1-based, paper numbering).

    Features are standardized per-batch (population std) — a free
    transformation available to any adversary, needed because raw feature
    scales vary by orders of magnitude across depths. Only the layers up
    to ``layer`` run, without autograd: the features are an input of the
    adversary's step.
    """
    feat = V.apply_layer_range(params, images, cfg, 0, layer)
    if feat.dim() == 2:                     # fc features -> (B,1,1,d)
        feat = feat[:, None, None, :]
    feat = feat.to(torch.float32)
    mu = torch.mean(feat)
    sd = torch.std(feat, correction=0) + 1e-6
    return (feat - mu) / sd


def _value_and_grad(fn: Callable, params):
    """(fn(params), d fn / d params) of a scalar loss over a nested dict of
    tensors."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = fn(live)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss.detach(), tree_map(lambda _: next(grads), live)


@contextlib.contextmanager
def _repeatable(device: torch.device):
    """cuDNN's deterministic algorithms on the card for the block: its
    default may pick a convolution backward that sums with atomics, and
    sixty GAN steps turn that rounding into another D loss each run."""
    if device.type != "cuda":
        yield
        return
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


class _Clock:
    """Marks on the device's timeline: CUDA events on the card (no
    synchronization until read), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        if not self.cuda:
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)


def adversary_step(gp, dp, g_opt: adamw.AdamWState, d_opt: adamw.AdamWState,
                   feat: torch.Tensor, real: torch.Tensor, meta_g, meta_d,
                   tcfg: TrainConfig, lr: float):
    """One D+G step, in the reference's order: D's loss and update with
    the current G, then G's loss against the updated D; each network has
    its own AdamW state. Returns (gp, dp, g_opt, d_opt, g_loss, d_loss)."""
    dl, dgrad = _value_and_grad(
        lambda d_: cgan.d_loss_fn(d_, gp, feat, real, meta_g, meta_d), dp)
    dp2, d_opt2, _ = adamw.update(dgrad, d_opt, dp, tcfg, lr)
    gl, ggrad = _value_and_grad(
        lambda g_: cgan.g_loss_fn(g_, dp2, feat, real, meta_g, meta_d)[0],
        gp)
    gp2, g_opt2, _ = adamw.update(ggrad, g_opt, gp, tcfg, lr)
    return gp2, dp2, g_opt2, d_opt2, gl, dl


def train_adversary(model_params, cfg: ModelConfig, layer: int, *,
                    steps: int = 200, batch: int = 16, n_eval: int = 64,
                    lr: float = 2e-4, seed: int = 0, log_every: int = 0,
                    device="cuda",
                    image_cache: Optional[dict] = None) -> AdversaryReport:
    """Trains the c-GAN on (Θ(X), X) from boundary ``layer`` and scores its
    reconstructions of held-out images by SSIM. ``image_cache``, a dict
    the caller shares across runs (``partition_search`` shares one over
    its walk), keeps the drawn images on ``device``: every run trains on
    the same batches."""
    dev = resolve_device(device)
    L.set_exact_float(dev)
    with _repeatable(dev):
        model_params = params_to_device(model_params, dev)
        img_size = cfg.image_size
        probe = collect_features(
            model_params, _images(0, 2, img_size, dev, image_cache), cfg,
            layer)
        feat_hw, feat_c = probe.shape[1], probe.shape[-1]

        g_defs, meta_g = cgan.generator_defs(feat_hw, feat_c, img_size)
        d_defs, meta_d = cgan.discriminator_defs(feat_hw, feat_c, img_size)
        kg, kd = prng.split(prng.PRNGKey(seed))
        gp = L.init_params_keyed(kg, g_defs, torch.float32, dev)
        dp = L.init_params_keyed(kd, d_defs, torch.float32, dev)
        tcfg = TrainConfig(learning_rate=lr, warmup_steps=0, total_steps=steps,
                           weight_decay=0.0, grad_clip=1.0, b1=0.5, b2=0.999)
        g_opt = adamw.init(gp, tcfg)
        d_opt = adamw.init(dp, tcfg)

        clock = _Clock(dev)
        marks = []                              # (collect, step, end) per step
        gl = dl = torch.zeros((), device=dev)
        for it in range(steps):
            real = _images(100 + it * batch, batch, img_size, dev, image_cache)
            m0 = clock.mark()
            feat = collect_features(model_params, real, cfg, layer)
            m1 = clock.mark()
            gp, dp, g_opt, d_opt, gl, dl = adversary_step(
                gp, dp, g_opt, d_opt, feat, real, meta_g, meta_d, tcfg, lr)
            marks.append((m0, m1, clock.mark()))
            if log_every and (it + 1) % log_every == 0:
                print(f"  layer {layer} step {it+1}: g={float(gl):.3f} "
                      f"d={float(dl):.3f}")

        # eval on held-out images
        real = _images(10_000_000, n_eval, img_size, dev, image_cache)
        feat = collect_features(model_params, real, cfg, layer)
        with torch.no_grad():
            fake = cgan.generator_apply(gp, feat, meta_g)
        s = float(ssim(fake, real))
        n = max(steps, 1)
        return AdversaryReport(
            layer=layer, ssim=s, g_loss=float(gl), d_loss=float(dl),
            steps=steps,
            collect_ms=sum(clock.ms(a, b) for a, b, _ in marks) / n,
            step_ms=sum(clock.ms(b, c) for _, b, c in marks) / n)


def partition_search(model_params, cfg: ModelConfig, *,
                     threshold: float = 0.35, steps: int = 150,
                     verify_depth: int = 2, max_layer: Optional[int] = None,
                     **kw) -> Tuple[int, List[AdversaryReport]]:
    """Algorithm 1. Returns (partition layer p, all reports). The walk's
    layers train on one set of images, drawn once (``image_cache``)."""
    n = max_layer or len(cfg.cnn_layers) - 1
    reports: List[AdversaryReport] = []
    cache: Dict[int, AdversaryReport] = {}
    kw.setdefault("image_cache", {})

    def eval_layer(l: int) -> AdversaryReport:
        if l not in cache:
            cache[l] = train_adversary(model_params, cfg, l, steps=steps,
                                       **kw)
            reports.append(cache[l])
        return cache[l]

    l = 1
    while l <= n:
        rep = eval_layer(l)
        if rep.ssim < threshold:
            # verify the next layers (non-monotone reconstructability)
            deeper = [eval_layer(m) for m in range(l + 1,
                                                   min(l + 1 + verify_depth,
                                                       n + 1))]
            if all(r.ssim < threshold for r in deeper):
                return l, reports
            # a deeper layer is reconstructable again: restart past it
            l = max(r.layer for r in deeper if r.ssim >= threshold) + 1
        else:
            l += 1
    return n, reports


# ----------------------------------------------------------------------------
# LM-family analogue: token-identity recovery probe
# ----------------------------------------------------------------------------

def token_recovery_probe(boundary_fn: Callable[[torch.Tensor], torch.Tensor],
                         vocab: int, d_model: int, *, steps: int = 100,
                         batch: int = 8, seq: int = 32, lr: float = 1e-2,
                         seed: int = 0, device="cuda") -> float:
    """Train a linear probe hidden->token-id; returns top-1 recovery acc.

    boundary_fn(tokens) must return the tier-1 boundary hidden states
    (what an adversary observes when tier-2 runs in the open) for int32
    ``tokens`` on ``device``.
    """
    dev = resolve_device(device)
    L.set_exact_float(dev)
    key = prng.PRNGKey(seed)
    w = torch.zeros((d_model, vocab), dtype=torch.float32, device=dev)

    def loss(w_, tokens, hidden):
        logits = hidden.to(torch.float32) @ w_
        return L.cross_entropy(logits, tokens, vocab)

    for _ in range(steps):
        key, k = prng.split(key)
        tokens = prng.randint(k, (batch, seq), 0, vocab, device=dev)
        with torch.no_grad():
            hidden = boundary_fn(tokens)
        _, g = _value_and_grad(lambda w_: loss(w_, tokens, hidden), w)
        w = w - lr * g

    key, k = prng.split(key)
    tokens = prng.randint(k, (batch * 4, seq), 0, vocab, device=dev)
    with torch.no_grad():
        hidden = boundary_fn(tokens)
        pred = torch.argmax(hidden.to(torch.float32) @ w, dim=-1)
    return float(torch.mean((pred == tokens).to(torch.float32)))
