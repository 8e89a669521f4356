"""The work of one FLUX.2 [dev] forward (diffusers' Flux2Transformer2DModel),
as a configuration's reference module gives it to `work.edit_items`.

What the default count (`work.forward_items`) gets wrong for this block:

  * the feed-forward is a SwiGLU: its in-projection is 2 x mlp wide, and
    the gate (silu(a) * b) is a kernel of its own that reads 2 x mlp and
    writes mlp a row, an "op" of the `fused` group;
  * the single block's fused projection is 3 x inner + 2 x mlp wide;
  * modulation is computed once a forward, one linear for the double
    blocks' image stream (6 x hidden), one for their text stream and one
    for the single blocks (3 x hidden), not once a block;
  * no pooled text vector; a timestep and a guidance embedding, each two
    linears.

No linear has a bias; `work.gemm_work` counts N bytes of one, under a
thousandth of a weight's bytes here.  Test data only: no cell runs it.
"""

from __future__ import annotations


def forward_items(config: dict, rows: int, s_kv: int, batch: int,
                  rags: bool) -> list[tuple]:
    m = config["model"]
    t = config["text"]["t_txt"]
    h, d, nh = m["hidden"], m["head_dim"], m["heads"]
    inner, mlp = nh * d, int(m["hidden"] * m["mlp_ratio"])
    b, e = batch, m["time_embed_dim"]
    keys = t + (s_kv if rags else rows)
    items = [("gemm", b * rows, h, m["in_channels"]),
             ("gemm", b, h, e), ("gemm", b, h, h),          # timestep
             ("gemm", b, h, e), ("gemm", b, h, h),          # guidance
             ("gemm", b, 6 * h, h), ("gemm", b, 6 * h, h),  # shared
             ("gemm", b, 3 * h, h),                          # modulation
             ("gemm", b * t, h, m["txt_in_dim"])]
    for _ in range(m["depth_double"]):
        for n in (rows, t):
            items += [("gemm", b * n, inner, h)] * 3
            items += [("gemm", b * n, h, inner), ("gemm", b * n, 2 * mlp, h),
                      ("op", "fused", 2 * b * n * 3 * mlp),
                      ("gemm", b * n, h, mlp)]
        items.append(("attn", b, nh, t + rows, keys, d))
    for _ in range(m["depth_single"]):
        n = t + rows
        items += [("gemm", b * n, 3 * inner + 2 * mlp, h),
                  ("op", "fused", 2 * b * n * 3 * mlp),
                  ("gemm", b * n, h, inner + mlp),
                  ("attn", b, nh, n, keys, d)]
    items += [("gemm", b, 2 * h, h), ("gemm", b * rows, m["out_channels"], h)]
    return items
