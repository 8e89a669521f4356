"""The yardstick: the card's peaks, the least time of a piece of work, and
the operations and bytes an edit's forwards need.

Peaks and `bound` are copied from `chip_smoke.py` (`PEAK_BF16`,
`HBM_BYTES_PER_S`, `bound`, `attention_work`): NVIDIA's H100 SXM data
sheet, dense bf16 tensor-core rate and HBM3 bandwidth at the full 700 W
power limit.  Counts are of what the inputs need: every input byte read
once, every output byte written once, no padded row, no masked key (a
RAGS query needs the text, the edited rows and the stored K / V of every
other image row; an edited row's stale entry is not needed).

A forward is a list of items: ("gemm", M, N, K) for a linear (bf16
operands, a bias of N), ("attn", B, H, T, S, D) for an attention of T
queries over S keys, and ("op", group, nbytes) for a bandwidth-bound
kernel of a kernel group (`kernel_groups/*.json`) that moves `nbytes`
and does no product.  An item of any other kind is an error.  Every item
belongs to a kernel group, the one whose device time its least time is
held against: a "gemm" to "gemm", an "attn" to "attention", an "op" to
its own, which has to be a group of `GROUPS_DIR`.

Whose count: a configuration's reference module (`reference.load`) may
give `forward_items(config, rows, s_kv, batch, rags)` for a block this
file's `forward_items` does not describe (a gated MLP, modulation shared
by every block, a fused kernel of its own); `edit_items` takes that one
where it is given and this file's otherwise.
"""

from __future__ import annotations

from perfbench import devtrace, reference

PEAK_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12   # bytes/s
BYTES = 2                   # bf16
KIND_GROUP = {"gemm": "gemm", "attn": "attention"}
GROUPS_DIR = devtrace.GROUPS_DIR


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the peak rate and the bytes at the HBM rate."""
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)


def gemm_work(m: int, n: int, k: int) -> tuple[float, float]:
    return 2.0 * m * n * k, BYTES * (m * k + k * n + m * n + n)


def attention_work(b: int, h: int, t: int, s: int, d: int
                   ) -> tuple[float, float]:
    """q [b, h, t, d] over s keys: QK^T and PV, 2 * 2 * t * s * d each
    head; q, k, v read and the output written once."""
    return (4.0 * b * h * t * s * d,
            BYTES * (2 * b * h * t * d + 2 * b * h * s * d))


def work(item) -> tuple[float, float]:
    """(FLOPs, bytes) of one item."""
    kind, *dims = item
    if kind == "gemm":
        return gemm_work(*dims)
    if kind == "attn":
        return attention_work(*dims)
    if kind == "op":
        return 0.0, float(dims[1])
    raise ValueError(f"work item of unknown kind: {item!r}")


def group(item) -> str:
    """The kernel group of one item."""
    if item[0] == "op":
        return item[1]
    if item[0] in KIND_GROUP:
        return KIND_GROUP[item[0]]
    raise ValueError(f"work item of unknown kind: {item!r}")


def forward_items(config: dict, rows: int, s_kv: int, batch: int,
                  rags: bool) -> list[tuple]:
    """The linears and attentions of one forward of the backbone over
    `rows` image rows per batch row (dense: noise + condition; RAGS: the
    edited tokens), `s_kv` stored image rows (RAGS keys), `batch` rows
    (2 under true CFG)."""
    m = config["model"]
    t = config["text"]["t_txt"]
    h, d, nh = m["hidden"], m["head_dim"], m["heads"]
    inner, mlp = nh * d, int(m["hidden"] * m["mlp_ratio"])
    b = batch
    keys = t + (s_kv if rags else rows)
    items = [("gemm", b * rows, h, m["in_channels"]),
             ("gemm", b, h, m["time_embed_dim"]), ("gemm", b, h, h)]
    if m["pooled_dim"]:
        items += [("gemm", b, h, m["pooled_dim"]), ("gemm", b, h, h)]
    if m["guidance_embed"]:
        items += [("gemm", b, h, m["time_embed_dim"]), ("gemm", b, h, h)]
    c = m.get("connector")
    if c:
        ch, cm = c["hidden"], int(c["hidden"] * c["mlp_ratio"])
        items += [("gemm", b * t, ch, c["in_dim"]),
                  ("gemm", b, ch, c["time_embed_dim"]), ("gemm", b, ch, ch),
                  ("gemm", b, ch, c["in_dim"]), ("gemm", b, ch, ch),
                  ("gemm", b, c["pooled_dim"], c["in_dim"])]
        for _ in range(c["depth"]):
            items += [("gemm", b, 2 * ch, ch)]
            items += [("gemm", b * t, ch, ch)] * 4
            items += [("gemm", b * t, cm, ch), ("gemm", b * t, ch, cm),
                      ("attn", b, c["heads"], t, t, ch // c["heads"])]
    items.append(("gemm", b * t, h, m["txt_in_dim"]))
    for _ in range(m["depth_double"]):
        items += [("gemm", b, 6 * h, h)] * 2
        for n in (rows, t):
            items += [("gemm", b * n, inner, h)] * 3
            items += [("gemm", b * n, h, inner), ("gemm", b * n, mlp, h),
                      ("gemm", b * n, h, mlp)]
        items.append(("attn", b, nh, t + rows, keys, d))
    for _ in range(m["depth_single"]):
        n = t + rows
        items += [("gemm", b, 3 * h, h), ("gemm", b * n, 3 * inner + mlp, h),
                  ("gemm", b * n, h, inner + mlp),
                  ("attn", b, nh, n, keys, d)]
    items += [("gemm", b, 2 * h, h), ("gemm", b * rows, m["out_channels"], h)]
    return items


def edit_items(config: dict, grid: int, stats: dict) -> list[tuple]:
    """Every forward of one edit by its plan statistics: the dense
    forwards over noise + condition rows, the computed RAGS forwards over
    the edited tokens; each forward counted by the configuration's own
    `forward_items` where its reference module gives one."""
    count = getattr(reference.load(config), "forward_items", forward_items)
    s = grid * grid
    batch = 2 if float(config["guidance"].get("true_cfg_scale", 1.0)) > 1 \
        else 1
    n_rags = stats["rags_steps"] - stats["reuse_steps"]
    items = (count(config, 2 * s, 2 * s, batch, False) * stats["dense_steps"]
             + count(config, stats["edited_tokens"], 2 * s, batch, True)
             * n_rags)
    ops = {it[1] for it in items if it[0] == "op"}
    if ops:
        stray = ops - {g for g, _ in devtrace.load_groups(GROUPS_DIR)}
        if stray:
            raise ValueError(
                f"configuration {config.get('name')!r} counts op items of "
                f"{sorted(stray)}, which no kernel_groups/*.json names")
    return items


def totals(items, kind: str | None = None) -> tuple[float, float]:
    """(FLOPs, least seconds) over the items of one kernel group, named
    by the group or by an item kind ("attn" is "attention"; None: all)."""
    want = KIND_GROUP.get(kind, kind)
    flops = least = 0.0
    for it in items:
        f, nb = work(it)
        if want is None or group(it) == want:
            flops += f
            least += bound_s(f, nb)
    return flops, least
