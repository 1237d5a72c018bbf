"""Greedy decoding, ported from ``marian_tpu/translator/greedy.py``: the
beam-size-1 incremental decode over the model's start_state/step API.

``greedy_decode`` runs the dense per-batch cache. There is no beam
reorder, so no beam_src reaches step() and the fused decode kernel's
``auto`` gate stays off: each step writes one position in place.

``greedy_decode_paged`` is the row-as-slot form of the same loop and the
library-call face of translator/iteration.py's serving engine: the
dense cache becomes a paged pool, every row decodes at its own position,
and a finished row releases its pages and leaves the step; the active
row count rounds up through the row buckets, so the step shrinks as the
batch drains. Both return the same tokens (the tests pin it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.vocab import EOS_ID
from ..ops.kernels.kv_pool import (DEFAULT_PAGE_LEN, KVPool, ROW_BUCKETS,
                                   bucket_rows, pages_for_tokens,
                                   state_key_groups)


def greedy_decode(model, params, src_ids: torch.Tensor,
                  src_mask: torch.Tensor, max_len: int) -> np.ndarray:
    """[B, max_len] int32 output ids, EOS-padded after each row's EOS
    (columns stop once every row has finished)."""
    with torch.inference_mode():
        b = src_ids.shape[0]
        enc_out = model.encode_for_decode(params, src_ids, src_mask)
        state = model.start_state(params, enc_out, src_mask, max_len)
        # ignored at step 0 (zero embedding)
        prev = torch.zeros((b, 1), dtype=torch.long, device=src_ids.device)
        finished = torch.zeros((b,), dtype=torch.bool, device=src_ids.device)
        outs = []
        for _ in range(max_len):
            logits, state = model.step(params, state, prev, src_mask)
            nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(finished, torch.full_like(nxt, EOS_ID), nxt)
            outs.append(nxt)
            finished = finished | (nxt == EOS_ID)
            prev = nxt[:, None]
            if bool(finished.all()):
                break
        return torch.stack(outs, dim=1).cpu().numpy().astype(np.int32)


def greedy_decode_paged(model, params, src_ids: torch.Tensor,
                        src_mask: torch.Tensor, max_len: int,
                        page_len: int = 0, row_buckets=None) -> np.ndarray:
    """Greedy decode over a paged KV pool with rows as slots; the same
    tokens as :func:`greedy_decode`, as [B, max_len] int32, EOS-padded
    after each row's EOS."""
    b = src_ids.shape[0]
    dev = src_ids.device
    page_len = int(page_len) or DEFAULT_PAGE_LEN
    buckets = tuple(sorted({min(x, b) for x in (row_buckets or ROW_BUCKETS)}))
    mp = pages_for_tokens(max_len, page_len)
    pool = KVPool(1 + b * mp, page_len, max_pages_per_row=mp)
    table = np.zeros((b, mp), np.int32)
    for r in range(b):
        table[r, :] = pool.claim(r, mp)
    pos = np.zeros((b,), np.int32)
    prev = np.zeros((b, 1), np.int64)
    alive = np.ones((b,), bool)
    out = np.full((b, max_len), EOS_ID, np.int32)
    with torch.inference_mode():
        enc = model.encode_for_decode(params, src_ids, src_mask)
        state = model.start_paged_state(params, enc, src_mask, 1 + b * mp,
                                        page_len, mp)
        row_keys, pool_keys, whole_keys = state_key_groups(state)
        for _ in range(max_len):
            if not alive.any():
                break
            rb = bucket_rows(int(np.nonzero(alive)[0].max()) + 1, buckets)
            sub = {k: state[k][:rb] for k in row_keys}
            sub.update({k: state[k] for k in pool_keys + whole_keys})
            sub["pos"] = torch.from_numpy(
                np.where(alive[:rb], pos[:rb], -1).astype(np.int32)).to(dev)
            sub["page_table"] = torch.from_numpy(table[:rb]).to(dev)
            logits, _ = model.step(params, sub,
                                   torch.from_numpy(prev[:rb]).to(dev),
                                   src_mask[:rb])
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for r in range(rb):
                if not alive[r]:
                    continue
                tok = int(nxt[r])
                out[r, pos[r]] = tok
                pos[r] += 1
                prev[r, 0] = tok
                if tok == EOS_ID or pos[r] >= max_len:
                    alive[r] = False
                    pool.release(r)           # the row's pages free NOW
                    table[r, :] = 0
    return out
