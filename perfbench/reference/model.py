"""The plain reference of both configurations: a molecular VAE in fp32.

Plain PyTorch, written from the architecture's equations and nothing of
the program (Gomez-Bombarelli et al. 2018, the ChemVAE lineage): a
one-hot SMILES (B, T, C) through VALID Conv1d layers along the T positions
with ReLU, flattened channel-major, a dense layer with SELU, the mean and
log-variance heads; z = mu + eps_scale * exp(logvar / 2) * eps; the
decoder embeds z (dense + SELU), feeds step t the embedding and the one-hot
of character t-1 (a learned start vector, or zeros, at t = 0) through a
stack of GRU layers (gates r|z|n, n = tanh(W_in x + b_in + r * (W_hn h +
b_hn))), and a dense head gives the logits of each step. The loss is the
summed cross-entropy of each molecule plus beta times its KL divergence
from N(0, I), averaged over the batch; the optimizer is Adam (0.9, 0.999,
1e-8) with bias correction.

Every product goes through ``q``, the precision of its operands: the
identity for the reference itself (fp32, TF32 off: ``strict_fp32``),
``fp8`` for the control of the cells' checks, or ``bf16``, the precision
that the configurations state, for a witness of what that precision alone
does to a run (``calibrate.py``). ``q`` rounds the operands of
the products that the configurations state in bf16 (the convolutions,
the dense layer, the latent embedding, the GRU and the output head); the
mean and log-variance heads stay fp32 as the configurations state them.
Parameter names are those of the program's state dict, so that one
dictionary of weights, made by the benchmark, is handed to both sides.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Rounding = Callable[[torch.Tensor], torch.Tensor]

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale per tensor (its largest
    magnitude at the format's largest value), as fp8 products take their
    operands; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (rounded - x).detach()


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (round to nearest even), as bf16 products take
    their operands, accumulated in fp32; the gradient passes straight
    through."""
    return x + (x.detach().to(torch.bfloat16).to(torch.float32) - x).detach()


@contextlib.contextmanager
def strict_fp32():
    """fp32 products with TF32 off (matmuls and cuDNN), restored after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd


# -- shapes ----------------------------------------------------------------------


def param_shapes(sizes: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, init bound) of every parameter: uniform in +-bound,
    bound = 1 / sqrt(fan_in) (1 / sqrt(H) for the GRU, 1 for the start
    vector)."""
    T, C, Lz, E, H = (sizes[k] for k in ("max_len", "charset_size", "latent_dim", "enc_hidden", "gru_hidden"))
    out, in_ch, length = [], C, T
    for i, (ch, k) in enumerate(zip(sizes["conv_channels"], sizes["conv_kernels"]), start=1):
        b = (in_ch * k) ** -0.5
        out += [(f"conv_{i}.weight", (ch, in_ch, k), b), (f"conv_{i}.bias", (ch,), b)]
        in_ch, length = ch, length - k + 1
    flat = in_ch * length
    for name, (i, o) in (("linear_0", (flat, E)), ("linear_1", (E, Lz)), ("linear_2", (E, Lz)),
                         ("linear_3", (Lz, Lz))):
        out += [(f"{name}.weight", (o, i), i ** -0.5), (f"{name}.bias", (o,), i ** -0.5)]
    g = H ** -0.5
    for li in range(sizes["gru_layers"]):
        i = Lz + C if li == 0 else H
        out += [(f"gru.weight_ih_l{li}", (3 * H, i), g), (f"gru.weight_hh_l{li}", (3 * H, H), g),
                (f"gru.bias_ih_l{li}", (3 * H,), g), (f"gru.bias_hh_l{li}", (3 * H,), g)]
    out += [("linear_4.weight", (C, H), H ** -0.5), ("linear_4.bias", (C,), H ** -0.5)]
    if sizes["learned_start"]:
        out.append(("start_token", (C,), 1.0))
    return out


# -- forward ---------------------------------------------------------------------


def _dense(x: torch.Tensor, p: Params, name: str, q: Rounding) -> torch.Tensor:
    return q(x) @ q(p[f"{name}.weight"]).T + p[f"{name}.bias"]


def encode(p: Params, sizes: dict, codes: torch.Tensor, q: Rounding = exact) -> Tuple[torch.Tensor, torch.Tensor]:
    """codes (B, T) -> (mu, logvar), each (B, latent_dim)."""
    h = F.one_hot(codes.long(), sizes["charset_size"]).float().transpose(1, 2)  # (B, C, T)
    for i in range(1, len(sizes["conv_channels"]) + 1):
        h = F.relu(F.conv1d(q(h), q(p[f"conv_{i}.weight"])) + p[f"conv_{i}.bias"][None, :, None])
    h = F.selu(_dense(h.reshape(h.shape[0], -1), p, "linear_0", q))
    return _dense(h, p, "linear_1", exact), _dense(h, p, "linear_2", exact)


def decode(p: Params, sizes: dict, z: torch.Tensor, teacher: torch.Tensor, q: Rounding = exact) -> torch.Tensor:
    """z (B, Lz) and the characters fed back (B, T) -> logits (B, T, C):
    step t sees character t-1 of ``teacher``, the start vector at t = 0."""
    B, T, C, H = z.shape[0], sizes["max_len"], sizes["charset_size"], sizes["gru_hidden"]
    z_emb = embed(p, z, q)
    prev = F.one_hot(teacher.long(), C).float()[:, :-1]
    prev = torch.cat([start(p, sizes, B, z.device)[:, None, :], prev], dim=1)
    x = torch.cat([z_emb[:, None, :].expand(B, T, z_emb.shape[1]), prev], dim=-1).transpose(0, 1)  # (T, B, I)
    for li in range(sizes["gru_layers"]):
        gi = q(x) @ q(p[f"gru.weight_ih_l{li}"]).T + p[f"gru.bias_ih_l{li}"]
        w_hh, b_hh = q(p[f"gru.weight_hh_l{li}"]).T, p[f"gru.bias_hh_l{li}"]
        h = z.new_zeros(B, H)
        outs = []
        for t in range(T):
            gh = q(h) @ w_hh + b_hh
            r = torch.sigmoid(gi[t, :, :H] + gh[:, :H])
            u = torch.sigmoid(gi[t, :, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(gi[t, :, 2 * H:] + r * gh[:, 2 * H:])
            h = (1.0 - u) * n + u * h
            outs.append(h)
        x = torch.stack(outs)
    return _dense(x.transpose(0, 1), p, "linear_4", q)


def embed(p: Params, z: torch.Tensor, q: Rounding = exact) -> torch.Tensor:
    """The decoder's embedding of z (B, Lz): dense + SELU."""
    return F.selu(_dense(z, p, "linear_3", q))


def start(p: Params, sizes: dict, batch: int, device) -> torch.Tensor:
    """(batch, C): what step 0 is fed, the start vector or zeros."""
    C = sizes["charset_size"]
    vec = p["start_token"] if sizes["learned_start"] else torch.zeros(C, device=device)
    return vec[None, :].expand(batch, C)


def decode_step(p: Params, sizes: dict, z_emb: torch.Tensor, h: torch.Tensor, prev: torch.Tensor,
                q: Rounding = exact) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the decoder: the embedding (N, Lz), the hidden states
    (L, N, H) and what is fed back (N, C) -> (logits (N, C), new states),
    the same equations as ``decode``."""
    H = sizes["gru_hidden"]
    x, out = torch.cat([z_emb, prev], dim=-1), []
    for li in range(sizes["gru_layers"]):
        gi = q(x) @ q(p[f"gru.weight_ih_l{li}"]).T + p[f"gru.bias_ih_l{li}"]
        gh = q(h[li]) @ q(p[f"gru.weight_hh_l{li}"]).T + p[f"gru.bias_hh_l{li}"]
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        u = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
        x = (1.0 - u) * n + u * h[li]
        out.append(x)
    return _dense(x, p, "linear_4", q), torch.stack(out)


def loss_of(p: Params, sizes: dict, codes: torch.Tensor, eps: torch.Tensor, beta: float,
            q: Rounding = exact, rows: Optional[int] = None) -> torch.Tensor:
    """The batch's mean of summed cross-entropy + beta * KL; ``eps`` the
    (B, Lz) reparameterisation noise. ``rows`` averages over the first
    rows only (a fault: half the batch left out)."""
    mu, logvar = encode(p, sizes, codes, q)
    z = mu + sizes["eps_scale"] * torch.exp(0.5 * logvar) * eps
    logits = decode(p, sizes, z, codes, q)
    recon = -torch.gather(torch.log_softmax(logits, dim=-1), -1, codes.long()[..., None])[..., 0].sum(-1)
    kl = -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar), dim=-1)
    per_row = recon + beta * kl
    return per_row.mean() if rows is None else per_row[:rows].mean()


# -- training --------------------------------------------------------------------


class Adam:
    """Adam with bias correction: m, v and the step count per parameter."""

    def __init__(self, p: Params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in p.items()}
        self.t = 0

    @torch.no_grad()
    def update(self, p: Params, grads: Params) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            p[k].addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def beta_at(sizes: dict, step: int) -> float:
    """The cyclical KL weight: a ramp over ``ratio`` of each cycle, then
    held at ``beta_max``."""
    pos = (step % sizes["kl_cycle_steps"]) / sizes["kl_cycle_steps"]
    return sizes["kl_beta_max"] * min(max(pos / sizes["kl_ratio"], 0.0), 1.0)


def train(p: Params, sizes: dict, batches: torch.Tensor, eps: List[torch.Tensor], q: Rounding = exact,
          rows: Optional[int] = None) -> Tuple[List[float], Adam]:
    """Steps 0 .. K-1 from ``p`` (updated in place) on ``batches`` (K, B, T)
    with each step's noise ``eps[i]``: (each step's loss, the optimizer)."""
    opt = Adam(p, sizes["learning_rate"])
    losses = []
    with strict_fp32():
        for i in range(batches.shape[0]):
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            loss = loss_of(leaves, sizes, batches[i], eps[i], beta_at(sizes, i), q, rows)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss.detach()))
            opt.update(p, dict(zip(leaves, grads)))
    return losses, opt


@torch.no_grad()
def served_logits(p: Params, sizes: dict, z: torch.Tensor, served: torch.Tensor, q: Rounding = exact,
                  block: int = 256) -> torch.Tensor:
    """Logits (B, T, C) at every position of the served tokens (B, T), each
    step fed the token served before it, in blocks of ``block`` rows."""
    with strict_fp32():
        return torch.cat([decode(p, sizes, z[i:i + block], served[i:i + block], q)
                          for i in range(0, z.shape[0], block)])
