"""Static-capacity gather/scatter of token rows by sentinel-padded ids.

Counterpart of `regione_tpu/core/masking.py`.  An id vector [K] holds the
edited token ids, padded with the sentinel S (one past the end).  JAX's
gathers read zeros for it (`mode='fill'`) and its scatters drop it
(`mode='drop'`); torch indexing raises on an out-of-range id, so both go
through a sink row appended at index S.

Ids and masks come shared by the batch ([K], [S]) or one row per image
([B, K], [B, S]: a batch of requests, each with its own partition, as the
JAX package's `vmap` over requests gives them).  Every image's pad slots
read 0 and are dropped.
"""

from __future__ import annotations

import numpy as np
import torch


def mask_to_padded_ids(mask, capacity: int) -> np.ndarray:
    """Host-side: bool mask [S] -> sorted int32 ids padded to `capacity`
    with the sentinel S (the highest ids are dropped past capacity)."""
    mask = np.asarray(mask, dtype=bool)
    s = mask.shape[0]
    ids = np.nonzero(mask)[0].astype(np.int32)[:capacity]
    out = np.full((capacity,), s, dtype=np.int32)
    out[: len(ids)] = ids
    return out


def _with_sink(x):
    """[B, S, D] -> [B, S + 1, D] with a zero row at index S."""
    return torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)


def _row_index(ids, s: int, d: int):
    """Per-image ids [B, K] as a gather/scatter index [B, K, d] into the
    sink-extended rows."""
    return torch.clamp(ids, max=s).long()[:, :, None].expand(-1, -1, d)


def gather_rows(x, ids):
    """Rows of [B, S, D] at padded ids [K] (shared) or [B, K] (per image)
    -> [B, K, D]; pad slots read 0."""
    if ids.dim() == 2:
        return torch.gather(_with_sink(x), 1,
                            _row_index(ids, x.shape[1], x.shape[2]))
    idx = torch.clamp(ids, max=x.shape[1]).long()
    return _with_sink(x).index_select(1, idx)


def scatter_rows(dst, ids, vals):
    """[B, K, D] rows into [B, S, D] at padded ids [K] or [B, K]; pad slots
    dropped."""
    s = dst.shape[1]
    out = _with_sink(dst)
    vals = vals.to(dst.dtype)
    if ids.dim() == 2:
        out.scatter_(1, _row_index(ids, s, dst.shape[2]), vals)
    else:
        out.index_copy_(1, torch.clamp(ids, max=s).long(), vals)
    return out[:, :s]


def where_rows(mask, a, b):
    """Row-wise select over [B, S, D]: mask [S] (shared) or [B, S]."""
    return torch.where(mask[..., None], a, b)
