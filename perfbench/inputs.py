"""What the benchmark makes from `--seed`, on the device: the weights and
the requests.  Both the program and the reference receive these bits.

Weights.  `layout(config)` lists every tensor of the backbone by its
state-dict name (the port's `MMDiT`, the names of the JAX param tree), with
its shape and how it is drawn:
  * a linear's weight and bias: uniform in +-1 / sqrt(fan_in) (the usual
    `nn.Linear` draw; biases are not zero, so every bias add is exercised);
  * a norm scale: uniform in [0.8, 1.2] (not 1, so a kernel that drops a
    scale differs); a LayerNorm bias and the connector's scale factor:
    uniform in +-0.1.
A configuration whose reference module gives a `layout` of its own is
drawn in that one instead: the harness hands it to `make_weights`.
Tensors drawn alike share one flat buffer in the served dtype, filled by
one `uniform_` on a CUDA generator: a few large calls, and the same bits
for the same seed on every run.  The tensors are views of the buffers.

Requests.  A mix file (`mixes/<name>.json`) gives the grid, the pool of
distinct requests and, per request, the side of the square block that the
edit changes.  Each request draws, in order, its initial noise, its text
embeddings (both CFG halves under true CFG), its pooled vector (FLUX), the
probe's first condition latent and the noise that fills the block.  The
block's position comes from `numpy.random.default_rng(seed)`.  Its
condition latent is `bench/common.py`'s `structured_condition` probe run
over the reference's plain forward (`probe`): the x0 estimate at the
partition step, the block replaced by noise, estimated again
`probe_iters` times.  The edit then changes that block (and its dilation)
and leaves the rest.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

W, NORM, SHIFT = "linear", "norm", "shift"


def layout(config: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, draw, fan_in) of every weight tensor, in a fixed
    order; draw is W (fan_in set), NORM or SHIFT."""
    m = config["model"]
    h, inner = m["hidden"], m["heads"] * m["head_dim"]
    mlp = int(h * m["mlp_ratio"])
    out: list = []

    def lin(name, d_in, d_out):
        out.append((name + ".weight", (d_out, d_in), W, d_in))
        out.append((name + ".bias", (d_out,), W, d_in))

    def embed(name, d_in, d_hidden):
        lin(name + ".in_", d_in, d_hidden)
        lin(name + ".out", d_hidden, d_hidden)

    lin("x_embedder", m["in_channels"], h)
    embed("time_in", m["time_embed_dim"], h)
    lin("txt_in", m["txt_in_dim"], h)
    lin("final_mod", h, 2 * h)
    lin("final_proj", h, m["out_channels"])
    for i in range(m["depth_double"]):
        p = f"double_blocks.{i}."
        lin(p + "img_mod", h, 6 * h)
        lin(p + "txt_mod", h, 6 * h)
        for a in ("img_attn", "txt_attn"):
            for c in "qkv":
                lin(f"{p}{a}.{c}", h, inner)
            lin(f"{p}{a}.out", inner, h)
            out.append((f"{p}{a}.norm_q.scale", (m["head_dim"],), NORM, 0))
            out.append((f"{p}{a}.norm_k.scale", (m["head_dim"],), NORM, 0))
        for s in ("img_mlp", "txt_mlp"):
            lin(f"{p}{s}.in_", h, mlp)
            lin(f"{p}{s}.out", mlp, h)
    if m["pooled_dim"]:
        embed("vector_in", m["pooled_dim"], h)
    if m["guidance_embed"]:
        embed("guidance_in", m["time_embed_dim"], h)
    c = m.get("connector")
    if c:
        ch, cmlp = c["hidden"], int(c["hidden"] * c["mlp_ratio"])
        lin("connector.in_proj", c["in_dim"], ch)
        embed("connector.t_embed", c["time_embed_dim"], ch)
        embed("connector.c_embed", c["in_dim"], ch)
        lin("connector.global_proj", c["in_dim"], c["pooled_dim"])
        out.append(("connector.scale_factor", (1,), SHIFT, 0))
        for j in range(c["depth"]):
            p = f"connector.blocks.{j}."
            for nrm in ("norm1", "norm2"):
                out.append((f"{p}{nrm}.scale", (ch,), NORM, 0))
                out.append((f"{p}{nrm}.bias", (ch,), SHIFT, 0))
            for s in "qkv":
                lin(f"{p}attn.{s}", ch, ch)
            lin(f"{p}attn.out", ch, ch)
            lin(f"{p}mlp.in_", ch, cmlp)
            lin(f"{p}mlp.out", cmlp, ch)
            lin(f"{p}mod", ch, 2 * ch)
    for i in range(m["depth_single"]):
        p = f"single_blocks.{i}."
        lin(p + "mod", h, 3 * h)
        lin(p + "linear1", h, 3 * inner + mlp)
        lin(p + "linear2", inner + mlp, h)
        out.append((p + "norm_q.scale", (m["head_dim"],), NORM, 0))
        out.append((p + "norm_k.scale", (m["head_dim"],), NORM, 0))
    return out


def _groups(entries):
    """{(draw, fan_in): [entries]} in a fixed order of keys."""
    groups: dict = {}
    for e in entries:
        groups.setdefault((e[2], e[3]), []).append(e)
    return dict(sorted(groups.items()))


def param_count(config: dict) -> int:
    return sum(math.prod(e[1]) for e in layout(config))


def make_weights(config: dict, gen: torch.Generator, device,
                 entries: list | None = None) -> dict:
    """{name: tensor} drawn from `gen`, one `uniform_` per group of
    tensors drawn alike, in the configuration's dtype on `device`, in the
    layout `entries` (`layout(config)` where none is given)."""
    dt = getattr(torch, config["dtype"])
    weights = {}
    groups = _groups(entries if entries is not None else layout(config))
    for (draw, fan_in), group in groups.items():
        n = sum(math.prod(e[1]) for e in group)
        buf = torch.empty(n, dtype=dt, device=device)
        if draw == W:
            lim = 1.0 / math.sqrt(fan_in)
            buf.uniform_(-lim, lim, generator=gen)
        elif draw == NORM:
            buf.uniform_(0.8, 1.2, generator=gen)
        else:
            buf.uniform_(-0.1, 0.1, generator=gen)
        off = 0
        for name, shape, _, _ in group:
            size = math.prod(shape)
            weights[name] = buf[off:off + size].view(shape)
            off += size
    return weights


@dataclasses.dataclass
class Request:
    """One edit's inputs: noise [1, S, C] fp32, txt [Bc, T, D] and pooled
    [Bc, P] in the model dtype, guidance [Bc] fp32, cond [1, S, C] fp32
    (set by `probe`), the block's mask [S] and its side."""
    index: int
    side: int
    noise: torch.Tensor
    txt: torch.Tensor
    pooled: torch.Tensor | None
    guidance: torch.Tensor | None
    block: np.ndarray
    cond: torch.Tensor | None = None
    cond0: torch.Tensor | None = None
    fill: torch.Tensor | None = None

    def as_dict(self) -> dict:
        """The reference's view of the request."""
        return {"cond": self.cond, "txt": self.txt, "pooled": self.pooled,
                "guidance": self.guidance}


def make_requests(config: dict, mix: dict, seed: int,
                  gen: torch.Generator, device) -> list[Request]:
    """The pool of `mix`'s requests, drawn from `gen` (noise, embeddings)
    and from `default_rng(seed)` (where each block lies, and the order in
    which the window cycles through the pool)."""
    m, txt_cfg = config["model"], config["text"]
    dt = getattr(torch, config["dtype"])
    grid, c_in = mix["grid"], m["in_channels"]
    s = grid * grid
    g = config["guidance"]
    bc = 2 if float(g.get("true_cfg_scale", 1.0)) > 1.0 else 1
    # the text encoder's features: the connector's input where there is
    # one, else the transformer's context width
    feat_dim = (m["connector"] or {}).get("in_dim", m["txt_in_dim"])
    rng = np.random.default_rng(seed)
    margin = mix["margin"]
    reqs = []
    for i, side in enumerate(mix["block_sides"]):
        noise = torch.randn((1, s, c_in), generator=gen, device=device)
        txt = torch.randn((bc, txt_cfg["t_txt"], feat_dim),
                          generator=gen, device=device).to(dt)
        pooled = None
        if m["pooled_dim"] and not m.get("connector"):
            pooled = torch.randn((bc, m["pooled_dim"]), generator=gen,
                                 device=device).to(dt)
        guidance = None
        if m["guidance_embed"]:
            guidance = torch.full((bc,), float(g["distilled_scale"]),
                                  dtype=torch.float32, device=device)
        cond0 = torch.randn((1, s, c_in), generator=gen, device=device)
        fill = torch.randn((side * side, c_in), generator=gen, device=device)
        y0, x0 = rng.integers(margin, grid - margin - side + 1, size=2)
        block = np.zeros((grid, grid), bool)
        block[y0:y0 + side, x0:x0 + side] = True
        reqs.append(Request(i, side, noise, txt, pooled, guidance,
                            block.reshape(-1), cond0=cond0, fill=fill))
    order = rng.permutation(len(reqs))
    return [reqs[j] for j in order]


@torch.inference_mode()
def probe(ref, req: Request, iters: int) -> None:
    """Sets `req.cond`: the reference's x0 estimate at the partition step,
    under the condition so far (first the request's own draw), with the
    block's rows replaced by the request's fill noise; `iters` times."""
    block = torch.as_tensor(req.block, device=req.noise.device)
    cond = req.cond0
    for _ in range(iters):
        req.cond = cond
        x0 = ref.x0_estimate(req.noise, req.as_dict())
        cond = x0.clone()
        cond[0, block] = req.fill
    req.cond = cond
    req.cond0 = req.fill = None
