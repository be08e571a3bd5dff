"""Telemetry anomaly models in PyTorch: the port's analytics.

Counterpart of ``gpud_tpu/models/anomaly.py``. Two models over per-chip
telemetry windows ``[chips, T, F]``:

1. ``robust_scores`` — the deterministic scorer: EWMA forecast residuals
   normalized by a median/MAD robust scale, reduced to a per-chip score.
   No parameters; runs on the device of its input.

2. The telemetry autoencoder — a small MLP whose reconstruction error flags
   multivariate anomalies. Its parameters are a plain ``AEParams`` tuple
   and its steps are functions, so ``parallel/fleet.py`` can shard them
   (batch over "data", hidden over "model"). ``TelemetryAutoencoder`` wraps
   the same functions as an ``nn.Module`` for readers who expect one.

Products take bf16 inputs and accumulate and return float32, as the
reference's ``dot_general(..., preferred_element_type=float32)``: each
operand is rounded to bf16 and multiplied in float32 (a product of two
bf16 values is exact in float32). The casts stay in the autograd graph,
so the gradient of each operand is rounded to bf16 too, as JAX's
transposed product is. TF32 must stay off for this (PyTorch's default);
the package sets no precision flag.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gpud_tpu_torch.device import DeviceLike, resolve_device

N_FEATURES = 8


# ---------------------------------------------------------------------------
# 1. Deterministic robust scorer
# ---------------------------------------------------------------------------

def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last dim (kept), the mean of the two middle values
    for an even count, as ``jnp.median``; ``torch.median`` would take the
    lower one. One sort; ``torch.quantile`` would sort too, and refuses
    inputs of more than 2^24 elements, which a fleet's windows exceed."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return (s[..., (n - 1) // 2:(n + 1) // 2] + s[..., n // 2:n // 2 + 1]) * 0.5


def _ewma(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Inclusive scan along the last dim of the affine maps s -> d * s + c,
    with (decay, contrib) = (0, x_0) at t = 0 and (1 - alpha, alpha * x_t)
    after: the EWMA initialized at the first sample. Hillis–Steele,
    ceil(log2 T) steps of tensor ops, with the reference's combine
    (da·db, vb + db·va)."""
    T = x.shape[-1]
    # built on the device: writing a Python float into a CUDA tensor
    # (d[0] = 0.0) copies it from the host and waits for the stream
    t = torch.arange(T, device=x.device)
    d = torch.where(t > 0, 1.0 - alpha, 0.0).to(x.dtype)
    v = alpha * x
    v[..., 0] = x[..., 0]
    s = 1
    while s < T:
        # element t absorbs the prefix that ends at t - s
        v_next = v.clone()
        v_next[..., s:] += d[s:] * v[..., :-s]
        d_next = d.clone()
        d_next[s:] *= d[:-s]
        v, d, s = v_next, d_next, 2 * s
    return v


def robust_scores(windows: torch.Tensor, alpha: float = 0.3) -> torch.Tensor:
    """Per-chip anomaly score from telemetry windows, on their device.

    Args:
      windows: [C, T, F] float (bf16 is cast to float32 first), T >= 2.
    Returns:
      [C] float32 — 0 ≈ nominal; >3 ≈ a feature is running away from its
      own recent behavior.
    """
    if windows.ndim != 3:
        raise ValueError(f"windows must be [C, T, F], got shape {tuple(windows.shape)}")
    if windows.shape[1] < 2:
        raise ValueError(
            f"robust_scores needs T >= 2 samples, got shape {tuple(windows.shape)}")
    # [C, F, T]: the scan, the medians and the top-k all run along the
    # last, contiguous dim
    x = windows.to(torch.float32).transpose(1, 2).contiguous()

    ewma = _ewma(x, alpha)
    resid = x[..., 1:] - ewma[..., :-1]  # one-step-ahead residuals

    # robust scale per chip/feature: median absolute deviation, floored
    # relative to the signal magnitude so near-constant features (fixed
    # clock, HBM total) don't turn LSB jitter into huge z-scores
    med = _median(resid)
    dev = (resid - med).abs()
    mad = _median(dev)
    xmag = _median(x.abs())
    scale = 1.4826 * mad + 1e-3 * (1.0 + xmag)
    z = dev / scale

    # score: mean of the top-k residual steps per chip (persistent
    # deviation, not single spikes)
    k = max(1, resid.shape[-1] // 8)
    return torch.topk(z.amax(dim=1), k, dim=-1).values.mean(dim=-1)


# ---------------------------------------------------------------------------
# 2. MLP autoencoder
# ---------------------------------------------------------------------------

class AEParams(NamedTuple):
    w_enc: torch.Tensor  # [F*T, H]
    b_enc: torch.Tensor  # [H]
    w_lat: torch.Tensor  # [H, Z]
    b_lat: torch.Tensor  # [Z]
    w_dec1: torch.Tensor  # [Z, H]
    b_dec1: torch.Tensor  # [H]
    w_dec2: torch.Tensor  # [H, F*T]
    b_dec2: torch.Tensor  # [F*T]


class AEConfig(NamedTuple):
    window: int = 16
    features: int = N_FEATURES
    hidden: int = 256
    latent: int = 32

    @property
    def input_dim(self) -> int:
        return self.window * self.features


def ae_init(
    cfg: AEConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> AEParams:
    """Glorot-normal weights (std sqrt(2 / (fan_in + fan_out))) and zero
    biases, drawn from ``generator`` on its own device and moved to
    ``device`` (the card unless ``"cpu"``). The draws differ from
    ``jax.random``'s; to compare with the reference, carry its parameters
    across with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen_device = generator.device if generator is not None else "cpu"
    d, h, z = cfg.input_dim, cfg.hidden, cfg.latent

    def glorot(fan_in, fan_out):
        w = torch.randn((fan_in, fan_out), generator=generator, device=gen_device)
        return (w * math.sqrt(2.0 / (fan_in + fan_out))).to(dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return AEParams(
        w_enc=glorot(d, h), b_enc=zeros(h),
        w_lat=glorot(h, z), b_lat=zeros(z),
        w_dec1=glorot(z, h), b_dec1=zeros(h),
        w_dec2=glorot(h, d), b_dec2=zeros(d),
    )


def params_from_numpy(
    arrays: Union[Mapping[str, object], Tuple[object, ...]], device: DeviceLike = None
) -> AEParams:
    """The port's parameters from numpy-convertible arrays: a mapping by
    field name, or a tuple in ``AEParams`` order (such as the reference's
    ``AEParams``), in the same [in, out] layout."""
    dev = resolve_device(device)
    if isinstance(arrays, Mapping):
        arrays = tuple(arrays[name] for name in AEParams._fields)
    if len(arrays) != len(AEParams._fields):
        raise ValueError(f"expected {len(AEParams._fields)} arrays, got {len(arrays)}")
    return AEParams(*(torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
                      for a in arrays))


def params_to_numpy(params: AEParams) -> dict:
    """``{field: float32 numpy array}``; ``AEParams(**result)`` of the
    reference takes it back."""
    return {name: p.detach().cpu().numpy() for name, p in zip(AEParams._fields, params)}


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and widened back to float32, inside the autograd
    graph: the gradient that flows through it is rounded to bf16 too."""
    return x.to(torch.bfloat16).float()


def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 inputs, float32 accumulation and result (the reference's
    ``dot_general`` with ``preferred_element_type=float32``)."""
    return bf16_round(a) @ bf16_round(w)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def ae_apply(params: AEParams, x: torch.Tensor) -> torch.Tensor:
    """x: [B, F*T] → reconstruction [B, F*T]."""
    h = gelu(mm(x, params.w_enc) + params.b_enc)
    zl = mm(h, params.w_lat) + params.b_lat
    h2 = gelu(mm(zl, params.w_dec1) + params.b_dec1)
    return mm(h2, params.w_dec2) + params.b_dec2


def ae_loss(params: AEParams, batch: torch.Tensor) -> torch.Tensor:
    recon = ae_apply(params, batch)
    return torch.mean(torch.square(recon - batch))


def ae_scores(params: AEParams, batch: torch.Tensor) -> torch.Tensor:
    """Per-sample reconstruction error — the anomaly score."""
    with torch.no_grad():
        recon = ae_apply(params, batch)
        return torch.mean(torch.square(recon - batch), dim=-1)


def ae_train_step(
    params: AEParams, batch: torch.Tensor, lr: float = 1e-3
) -> Tuple[AEParams, torch.Tensor]:
    """One SGD step with gradients from ``torch.autograd``. Returns
    ``(new_params, loss)`` and leaves ``params`` as they were."""
    with torch.enable_grad():
        leaves = AEParams(*(p.detach().requires_grad_() for p in params))
        loss = ae_loss(leaves, batch)
        grads = torch.autograd.grad(loss, leaves)
    new_params = AEParams(*(p.detach() - lr * g for p, g in zip(leaves, grads)))
    return new_params, loss.detach()


def windows_to_batch(windows: torch.Tensor) -> torch.Tensor:
    """[C, T, F] → [C, T*F] flattened samples for the autoencoder."""
    return windows.reshape(windows.shape[0], -1).to(torch.float32)


class TelemetryAutoencoder(nn.Module):
    """The autoencoder as an ``nn.Module``: the eight tensors of an
    ``AEParams`` as parameters, ``forward`` = :func:`ae_apply`. The
    functions above stay the API that ``parallel/fleet.py`` shards."""

    def __init__(self, params: AEParams):
        super().__init__()
        for name, p in zip(AEParams._fields, params):
            setattr(self, name, nn.Parameter(p.detach().clone()))

    def ae_params(self) -> AEParams:
        return AEParams(*(getattr(self, name) for name in AEParams._fields))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ae_apply(self.ae_params(), x)
