"""Arrow delivery of the port's batch results, and Arrow IPC.

The port's own copy of the reference package's ``tpu/arrow_bridge.py``
(without its two observability calls, whose registry is a later slice of
the port).  A :class:`~logparser_tpu_torch.tpu.batch.BatchResult` becomes a
pyarrow Table with one column per requested field:

- span columns as ``string_view`` (``strings="view"``): 16-byte views
  whose long values reference the batch's [B, L] buffer in place; where
  the card emitted its view rows (``pack_rows``' four rows a span field)
  the views are interleaved from them (``native.views_interleave``)
  without reading the buffer, else built from the starts and lengths
  (``native.build_views``); URI-repair, ``?&`` and override rows are
  patched to a side buffer;
- or as ``string`` (``strings="copy"``): one native gather of the span
  columns without overrides (``BatchResult.span_bytes_many``), repair rows
  spliced in, and a column with string overrides cast from its views
  (where the reference builds it row by row);
- numeric columns as int64 with a null bitmap, GeoIP vocabulary columns
  as ``dictionary.take(codes)``, typed GeoIP numbers as their arrays;
- wildcard columns as ``map<string, string>``, built from the flat
  segment buffers (``_LazyWildcard.to_arrow_map``) where it can.

Only the leftovers (non-string overrides, non-UTF-8 bytes, mixed object
columns) take ``to_pylist``'s per-row path.  ``parse_to_ipc`` is the
one-call IPC surface.
"""
from __future__ import annotations

import io
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .batch import BatchResult

# Sentinel from the batched view prefetch: "this column was tried and
# cannot take the view path" — _column_to_arrow goes straight to the
# copy fallback instead of rebuilding the column only to fail again.
_VIEW_FAILED = object()

# Per-vocab Arrow dictionary cache: a production City database holds
# about 1e5 names — rebuilding the pa.string() dictionary per batch would
# out-cost the take() fast path it feeds.  Keyed by id() with the vocab
# object retained (keeps the id stable); live vocabs are few (one per
# mmdb column), but a service that RELOADS its databases would otherwise
# accumulate stale multi-MB entries forever — bound the cache and drop
# the oldest half when it fills (refilling a live vocab is one cheap
# rebuild).
_PA_VOCAB_CACHE: Dict[int, Any] = {}
_PA_VOCAB_CACHE_MAX = 32


def _null_bitmap(valid: np.ndarray):
    """Arrow null-bitmap bytes for a boolean validity vector, or None
    when every row is valid (Arrow's all-valid shorthand).  Single home
    for the little-endian packbits idiom."""
    if valid.all():
        return None
    return np.packbits(valid, bitorder="little")


def _pa_vocab(dvals):
    import pyarrow as pa

    ent = _PA_VOCAB_CACHE.get(id(dvals))
    if ent is None:
        if len(_PA_VOCAB_CACHE) >= _PA_VOCAB_CACHE_MAX:
            for k in list(_PA_VOCAB_CACHE)[: _PA_VOCAB_CACHE_MAX // 2]:
                del _PA_VOCAB_CACHE[k]
        ent = (dvals, pa.array(list(dvals), type=pa.string()))
        _PA_VOCAB_CACHE[id(dvals)] = ent
    return ent[1]



def _spans_to_string_array(
    result: "BatchResult", field_id: str, flat: Optional[Any] = None
) -> Optional[Any]:
    """Vectorized span -> pa.StringArray built on BatchResult.span_bytes
    (the single flat-gather implementation: validity mask, native gather,
    ?&-normalization).  ``flat`` carries a prefetched (data, offsets,
    valid) triple from the batch-wide multi-column gather.  Returns None
    when the column needs the per-row path or the gathered bytes are not
    valid UTF-8."""
    import pyarrow as pa

    B = result.lines_read
    if B == 0:
        return pa.array([], type=pa.string())
    if flat is None:
        flat = result.span_bytes(field_id)
    if flat is None:
        return None
    data, offsets64, valid = flat
    data, offsets64 = _splice_fix_rows(result, field_id, data, offsets64, valid)
    if int(offsets64[-1]) > np.iinfo(np.int32).max:
        # int32 StringArray offsets would wrap; don't rely on validate()
        # catching it after the full gather — take the fallback path now.
        return None
    data = np.ascontiguousarray(data)
    if data.base is not None:
        # A view into the batch-wide multi-column gather buffer: wrapping
        # it zero-copy into the Arrow buffer would pin EVERY span
        # column's bytes for as long as this one column lives.  Copy the
        # column's own bytes (one memcpy, small next to the gather).
        data = data.copy()
    offsets = offsets64.astype(np.int32)
    null_bitmap = np.packbits(valid, bitorder="little")
    # pa.py_buffer wraps the numpy arrays zero-copy (buffer protocol);
    # .tobytes() here would duplicate the data buffer per batch.
    arr = pa.StringArray.from_buffers(
        B,
        pa.py_buffer(offsets),
        pa.py_buffer(data),
        pa.py_buffer(null_bitmap),
    )
    if result.ascii_only:
        # Every source byte is < 0x80, so every gathered span is valid
        # UTF-8 by construction — the per-column validate pass (a third
        # of the column build cost) is provably redundant.
        return arr
    try:
        arr.validate(full=True)  # UTF-8 check happens here
    except pa.ArrowInvalid:
        return None
    return arr


_HEX_VAL = np.full(256, -1, dtype=np.int16)
for _c in b"0123456789":
    _HEX_VAL[_c] = _c - ord("0")
for _c in b"abcdef":
    _HEX_VAL[_c] = _c - ord("a") + 10
for _c in b"ABCDEF":
    _HEX_VAL[_c] = _c - ord("A") + 10
_IS_HEX = _HEX_VAL >= 0
# Printable URI encode-set bytes (postproc.split_uri_fast's `enc`): the
# host %-escapes these before any other repair stage.  Built from the
# host dissector's own constant so device and host cannot drift.
from ..dissectors.uri import ENCODE_PRINTABLE as _ENCODE_PRINTABLE

_IS_ENC = np.zeros(256, dtype=bool)
for _c in _ENCODE_PRINTABLE:
    _IS_ENC[_c] = True
_HEX_UPPER = np.frombuffer(b"0123456789ABCDEF", dtype=np.uint8)


def _repair_fix_segments(seg, seg_off, mode):
    """Vectorized URI repair over concatenated fix-row bytes.

    The repair semantics (%-bad-escape rewrite + path %XX decode,
    HttpUriDissector.java:166-167 / java.net.URI decode) run VECTORIZED
    in fix-row space: rows whose escapes are all well-formed ``%XX``
    decode with numpy scatter/gather; only rows with bad escapes,
    non-ASCII raw bytes, or non-ASCII decode results (UTF-8 replacement
    semantics) take the per-row ``_fix_uri_part`` path.  Returns
    (flat, lens): one repaired value per input row, in order (unchanged
    rows keep their original bytes).  Per-row python values re-encode
    through UTF-8, so they are valid by construction."""
    from .batch import _fix_uri_part

    n_rows = len(seg_off) - 1

    from ..native import copy_spans, repair_spans

    native = repair_spans(seg, seg_off, mode not in ("path", "userinfo"),
                          _IS_ENC)
    if native is not None:
        out_flat, out_lens, py_flags = native
        if not py_flags.any():
            if np.array_equal(out_lens, np.diff(seg_off)):
                # Nothing changed (any real native repair changes a
                # row's length): return the INPUT so callers' identity
                # checks skip their column rebuilds.
                return seg, out_lens
            return out_flat, out_lens
        py_idx = np.nonzero(py_flags)[0]
        py_bytes = [
            _fix_uri_part(
                bytes(seg[seg_off[j]: seg_off[j + 1]]).decode(
                    "utf-8", "replace"), mode,
            ).encode("utf-8")
            for j in py_idx.tolist()
        ]
        out_off = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(out_lens, out=out_off[1:])
        src_base = out_off[:-1].copy()
        new_lens = out_lens.copy()
        base = len(out_flat)
        off = 0
        for j, v in zip(py_idx.tolist(), py_bytes):
            src_base[j] = base + off
            new_lens[j] = len(v)
            off += len(v)
        combined = np.concatenate(
            [out_flat, np.frombuffer(b"".join(py_bytes), dtype=np.uint8)]
        )
        final_off = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(new_lens, out=final_off[1:])
        return copy_spans(combined, src_base, final_off), new_lens

    total = int(seg_off[-1])
    seg_lens = np.diff(seg_off)
    row_id = np.repeat(np.arange(n_rows, dtype=np.int64), seg_lens)

    # Classify every '%' as a well-formed %XX escape or a bad escape
    # (reference _BAD_ESCAPE_PATTERN: % not followed by two hex digits,
    # including at end-of-value).
    nxt1 = np.zeros(total, dtype=np.uint8)
    nxt2 = np.zeros(total, dtype=np.uint8)
    same1 = np.zeros(total, dtype=bool)
    same2 = np.zeros(total, dtype=bool)
    if total > 1:
        nxt1[:-1] = seg[1:]
        same1[:-1] = row_id[1:] == row_id[:-1]
    if total > 2:
        nxt2[:-2] = seg[2:]
        same2[:-2] = row_id[2:] == row_id[:-2]
    pct = seg == ord("%")
    good = pct & same1 & same2 & _IS_HEX[nxt1] & _IS_HEX[nxt2]
    bad = pct & ~good

    def row_any(mask):
        out = np.zeros(n_rows, dtype=bool)
        if mask.any():
            out[np.unique(row_id[mask])] = True
        return out

    # Rows needing the exact per-row semantics: raw non-ASCII bytes (the
    # UTF-8 decode-replace round trip can rewrite invalid sequences) and,
    # in path mode, non-ASCII decode results (multi-escape runs decode as
    # one UTF-8 unit).  Everything else vectorizes:
    # - The reference's TWICE-applied sequential %25 rewrite
    #   (HttpUriDissector.java:166-167) is equivalent to ONE simultaneous
    #   "insert 25 after every originally-bad %": pass-1 consumption can
    #   only defer a bad escape's rewrite to pass 2 (never prevent it),
    #   a rewritten escape is %25-good and never rematched, and no
    #   insertion can land between a good % and its two hex digits.
    # - In path mode, repairing a bad escape then decoding it
    #   (%zz -> %25zz -> %zz) is the identity, so bad escapes simply stay
    #   literal and only good %XX escapes substitute their byte.
    enc = _IS_ENC[seg]
    py_rows = row_any(seg >= 0x80)
    if mode in ("path", "userinfo"):
        # Decoding modes: good %XX escapes substitute their byte; bad
        # escapes stay literal (the %25-repair and the later decode
        # cancel); encode-set bytes are an encode->decode identity.
        dec = ((_HEX_VAL[nxt1] << 4) | np.maximum(_HEX_VAL[nxt2], 0)).astype(
            np.int16
        )
        py_rows |= row_any(good & (dec >= 0x80))
        vec_changed = row_any(good) & ~py_rows
    else:
        # Escaping modes (query): well-formed escapes are untouched; bad
        # escapes gain a '25' insertion and encode-set bytes expand to
        # their uppercase %XX triple.
        vec_changed = row_any(bad | enc) & ~py_rows

    py_idx = np.nonzero(py_rows)[0]
    new_lens = seg_lens.astype(np.int64, copy=True)
    src_base = seg_off[:-1].astype(np.int64, copy=True)
    pieces = [seg]
    if vec_changed.any():
        in_vec = vec_changed[row_id]
        if mode in ("path", "userinfo"):
            # Drop the two hex tail bytes of each good escape, replace
            # the '%' with the decoded byte.
            g = good & in_vec
            tail = np.zeros(total, dtype=bool)
            tail[1:] |= g[:-1]
            tail[2:] |= g[:-2]
            keep = in_vec & ~tail
            new_seg = np.where(g, dec.astype(np.uint8), seg)[keep]
            row_counts = np.bincount(row_id[keep], minlength=n_rows)
        else:
            # Simultaneous bad-escape rewrite + encode: a bad '%' expands
            # to '%25', an encode-set byte to its uppercase '%XX' triple.
            sel = in_vec
            sv = seg[sel]
            bv = (bad & in_vec)[sel]
            ev = (enc & in_vec)[sel]
            rid_v = row_id[sel]
            counts = np.where(bv | ev, 3, 1).astype(np.int64)
            out_pos = np.zeros(sv.size + 1, dtype=np.int64)
            np.cumsum(counts, out=out_pos[1:])
            new_seg = np.repeat(sv, counts)
            ins = out_pos[:-1][bv]
            new_seg[ins + 1] = ord("2")
            new_seg[ins + 2] = ord("5")
            ein = out_pos[:-1][ev]
            new_seg[ein] = ord("%")
            new_seg[ein + 1] = _HEX_UPPER[sv[ev] >> 4]
            new_seg[ein + 2] = _HEX_UPPER[sv[ev] & 0x0F]
            row_counts = np.bincount(
                rid_v, weights=counts, minlength=n_rows
            ).astype(np.int64)
        vloc = np.nonzero(vec_changed)[0]
        voff = np.zeros(vloc.size + 1, dtype=np.int64)
        np.cumsum(row_counts[vloc], out=voff[1:])
        src_base[vloc] = len(seg) + voff[:-1]
        new_lens[vloc] = row_counts[vloc]
        pieces.append(new_seg)
    if py_idx.size:
        py_bytes = [
            _fix_uri_part(
                bytes(seg[seg_off[j] : seg_off[j + 1]]).decode("utf-8", "replace"),
                mode,
            ).encode("utf-8")
            for j in py_idx.tolist()
        ]
        py_buf = np.frombuffer(b"".join(py_bytes), dtype=np.uint8)
        base = sum(len(p) for p in pieces)
        off = 0
        for j, v in zip(py_idx.tolist(), py_bytes):
            src_base[j] = base + off
            new_lens[j] = len(v)
            off += len(v)
        pieces.append(py_buf)

    from ..native import copy_spans

    if len(pieces) == 1:
        return seg, seg_lens.astype(np.int64)
    combined = np.concatenate(pieces)
    out_off = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(new_lens, out=out_off[1:])
    return copy_spans(combined, src_base, out_off), new_lens


def _splice_fix_rows(result: "BatchResult", field_id: str, data, offsets, valid):
    """Patch URI-repair (`fix`) rows into gathered flat span bytes: the
    flat gather copies repair rows RAW; :func:`_repair_fix_segments`
    produces their repaired values, spliced back with the native threaded
    memcpy fan-out."""
    col = result.column(field_id)
    fix = col.get("fix")
    B = result.lines_read
    if fix is None:
        return data, offsets
    rows = np.nonzero(np.asarray(fix[:B], dtype=bool) & valid)[0]
    if rows.size == 0:
        return data, offsets
    lens = np.diff(offsets)
    seg_lens = lens[rows]
    n_rows = rows.size
    seg_off = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(seg_lens, out=seg_off[1:])
    total = int(seg_off[-1])
    idx = np.repeat(offsets[rows] - seg_off[:-1], seg_lens) + np.arange(
        total, dtype=np.int64
    )
    seg = data[idx]
    rep_flat, rep_lens = _repair_fix_segments(seg, seg_off, col["fix_mode"])
    if rep_flat is seg:
        return data, offsets

    from ..native import copy_spans

    rep_off = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(rep_lens, out=rep_off[1:])
    src_base = offsets[:-1].astype(np.int64, copy=True)
    new_lens = lens.astype(np.int64, copy=True)
    src_base[rows] = len(data) + rep_off[:-1]
    new_lens[rows] = rep_lens
    combined = np.concatenate([data, rep_flat])
    new_off = np.zeros_like(offsets)
    np.cumsum(new_lens, out=new_off[1:])
    # Rebuild via the native threaded memcpy fan-out (numpy's per-element
    # fancy-index gather was the splice's hot spot).
    return copy_spans(combined, src_base, new_off), new_off


def _view_column_inputs(result: "BatchResult", field_id: str, buf,
                        base: Optional[Any] = None):
    """Per-column prep for the view materializer: (starts, lens_main,
    state) where state carries everything the assembly step needs.
    ``base`` optionally carries the batched (valid, starts, lens) triple
    computed once for all columns.  Returns None when the column must
    take the copy path."""
    col = result.column(field_id)
    if col["kind"] != "span":
        return None
    B = result.lines_read
    overrides = result._overrides.get(field_id, {})
    ov_rows: List[int] = []
    ov_vals: List[bytes] = []
    for r, v in overrides.items():
        if v is None:
            continue
        if not isinstance(v, str):
            return None
        ov_rows.append(r)
        ov_vals.append(v.encode("utf-8"))

    if base is not None:
        valid, starts, lens = base
    else:
        valid = (
            np.asarray(result.valid[:B]).astype(bool)
            & np.asarray(col["ok"][:B]).astype(bool)
            & ~np.asarray(col["null"][:B]).astype(bool)
        )
        starts = np.asarray(col["starts"][:B], dtype=np.int32)
        lens = np.where(
            valid, np.asarray(col["ends"][:B]) - starts, -1
        ).astype(np.int32)
    arr_valid = valid if not overrides else valid.copy()
    for r, v in overrides.items():
        arr_valid[r] = v is not None
    if ov_rows:
        lens = lens.copy()
        lens[np.asarray(ov_rows)] = -1  # patched from the side buffer

    fix = col.get("fix")
    amp = col.get("amp")
    fix_m = (
        np.asarray(fix[:B], dtype=bool) & valid
        if fix is not None else None
    )
    if fix_m is not None and not fix_m.any():
        fix_m = None
    amp_m = None
    if amp is not None:
        cand = np.asarray(amp[:B], dtype=bool) & valid & (lens > 0)
        if cand.any():
            first = buf[np.nonzero(cand)[0], starts[cand]]
            cand[np.nonzero(cand)[0]] = first == np.uint8(ord("?"))
            amp_m = cand if cand.any() else None
    if ov_rows and (fix_m is not None or amp_m is not None):
        sel = np.zeros(B, dtype=bool)
        sel[np.asarray(ov_rows)] = True
        if fix_m is not None:
            fix_m &= ~sel
        if amp_m is not None:
            amp_m &= ~sel
    def sp_tuple(mask):
        """Per-special-row data for the fused native assembler, in
        special-row order: (rows, span lens, fix flags, amp flags)."""
        rows = np.nonzero(mask)[0]
        return (
            rows,
            lens[rows].astype(np.int64),
            (fix_m[rows].astype(np.uint8) if fix_m is not None
             else np.zeros(rows.size, dtype=np.uint8)),
            (amp_m[rows].astype(np.uint8) if amp_m is not None
             else np.zeros(rows.size, dtype=np.uint8)),
        )

    if fix_m is not None or amp_m is not None:
        special = (
            fix_m if amp_m is None
            else (amp_m if fix_m is None else fix_m | amp_m)
        )
        lens_main = lens.copy()
        lens_main[special] = -1  # patched from the side buffer
        # Precomputed (line-invariant, like the masks above) special-row
        # data.  sp_dev is the reduced set for DEVICE-emitted views:
        # amp-only rows of <= 12 bytes are fully inline and the device
        # already rendered their '&', so only fix rows and long amp rows
        # need the host side buffer.
        sp = sp_tuple(special)
        if amp_m is not None:
            amp_only = amp_m if fix_m is None else (amp_m & ~fix_m)
            reduced = special & ~(amp_only & (lens <= 12))
            sp_dev = sp_tuple(reduced) if reduced.any() else None
        else:
            sp_dev = sp
    else:
        special = None
        lens_main = lens
        sp = None
        sp_dev = None
    state = {
        "col": col, "valid": valid, "arr_valid": arr_valid, "lens": lens,
        "special": special, "fix_m": fix_m, "amp_m": amp_m,
        "ov_rows": ov_rows, "ov_vals": ov_vals, "sp": sp, "sp_dev": sp_dev,
        # Cached Arrow null bitmap (None = no nulls), packed once a column.
        "null_bitmap": _null_bitmap(arr_valid),
    }
    return starts, lens_main, state


def _assemble_view_array(result: "BatchResult", buf, starts, views, state,
                         dev_views: bool = False, threads: int = 0):
    """Side-buffer handling + pa.Array assembly for one view column.
    ``dev_views`` marks views interleaved from device-emitted rows (short
    amp-only rows are already rendered inline there).  ``threads`` caps
    the native side-buffer fan-out (pooled per-column callers pass 1 so
    the column-level parallelism supplies the concurrency)."""
    import pyarrow as pa

    from ..native import (
        assemble_special, copy_spans, patch_views, scatter_spans,
    )

    col = state["col"]
    arr_valid = state["arr_valid"]
    lens = state["lens"]
    special = state["special"]
    fix_m = state["fix_m"]
    amp_m = state["amp_m"]
    ov_rows, ov_vals = state["ov_rows"], state["ov_vals"]
    # Device-emitted views already carry the '&' of short (inline)
    # amp-only rows — only the reduced special set needs the side buffer.
    sp = state["sp_dev"] if dev_views else state["sp"]
    B = result.lines_read
    L = buf.shape[1]
    views = np.ascontiguousarray(views.reshape(B, 16))
    variadic = [pa.py_buffer(buf.reshape(-1))]
    fused = None
    if special is not None and sp is not None:
        # Fused native path: ONE scan+write pair builds the side buffer
        # and patches the views straight from the batch buffer (the
        # unfused flow below is numpy indexing and per-call dispatch
        # around little byte work).
        sp_rows, sp_lens, sp_fix, sp_amp = sp
        mode_str = col.get("fix_mode")
        fused = assemble_special(
            buf, starts, sp_rows, sp_lens, sp_fix, sp_amp,
            0 if mode_str in ("path", "userinfo") else 1,
            _IS_ENC, views, len(variadic), threads=threads,
        )
    if fused == "overflow":
        # >2 GiB side buffer would wrap the int32 view offsets: the
        # column takes the copy path (which guards offsets itself).
        return None
    # dev route with an empty reduced set: every special row was rendered
    # inline on device; nothing to patch.
    handled_inline = special is not None and sp is None and dev_views
    if fused is not None:
        from .batch import _fix_uri_part

        side, side_off, py_flags = fused
        variadic.append(pa.py_buffer(side))
        if py_flags.any():
            # Exact Python UTF-8 semantics for the flagged rows (non-ASCII
            # bytes / non-ASCII decode results): amp-normalize, repair,
            # patch from an extra side buffer.  Twin of the py-row flow in
            # _repair_fix_segments — change both together (the fuzz suite
            # locks them against the oracle).
            sp_rows, sp_lens, sp_fix, sp_amp = sp
            py_sel = np.nonzero(py_flags)[0]
            py_vals = []
            for k in py_sel.tolist():
                r = int(sp_rows[k])
                raw = bytes(buf[r, starts[r]: starts[r] + int(sp_lens[k])])
                if sp_amp[k]:
                    raw = b"&" + raw[1:]
                py_vals.append(
                    _fix_uri_part(
                        raw.decode("utf-8", "replace"), col["fix_mode"]
                    ).encode("utf-8")
                )
            py_flat = np.frombuffer(b"".join(py_vals), dtype=np.uint8)
            py_off = np.zeros(len(py_vals) + 1, dtype=np.int64)
            np.cumsum([len(v) for v in py_vals], out=py_off[1:])
            patch_views(views, sp_rows[py_sel], py_flat, py_off,
                        len(variadic))
            variadic.append(pa.py_buffer(py_flat))
    elif special is not None and not handled_inline:
        # Single-allocation side-buffer assembly: repair segments gather
        # straight from the batch buffer, then clean-special and repaired
        # rows SCATTER into one final buffer (the former flow copied all
        # special bytes up to three times: sub -> f_seg -> concat+recopy).
        rows = np.nonzero(special)[0]
        sub_lens = lens[rows].astype(np.int64)
        src_off = rows.astype(np.int64) * L + starts[rows]
        fix_sub = (
            np.nonzero(fix_m[rows])[0] if fix_m is not None
            else np.empty(0, dtype=np.int64)
        )
        rep_flat = None
        if fix_sub.size:
            f_lens = sub_lens[fix_sub]
            f_off = np.zeros(fix_sub.size + 1, dtype=np.int64)
            np.cumsum(f_lens, out=f_off[1:])
            f_seg = copy_spans(buf.reshape(-1), src_off[fix_sub], f_off)
            if amp_m is not None:
                # ?->& applies before repair sees the bytes (repair rows
                # can carry the query-normalization flag too).
                amp_fix = amp_m[rows][fix_sub]
                if amp_fix.any():
                    f_seg[f_off[:-1][amp_fix]] = np.uint8(ord("&"))
            rep_flat, rep_lens = _repair_fix_segments(
                f_seg, f_off, col["fix_mode"]
            )
            rep_off = np.zeros(fix_sub.size + 1, dtype=np.int64)
            np.cumsum(rep_lens, out=rep_off[1:])
        new_lens = sub_lens
        if rep_flat is not None:
            new_lens = sub_lens.copy()
            new_lens[fix_sub] = rep_lens
        sub_off = np.zeros(rows.size + 1, dtype=np.int64)
        np.cumsum(new_lens, out=sub_off[1:])
        if int(sub_off[-1]) >= 2**31:
            return None  # int32 view offsets would wrap: copy path
        sub = np.empty(int(sub_off[-1]), dtype=np.uint8)
        if fix_sub.size:
            nonfix = np.ones(rows.size, dtype=bool)
            nonfix[fix_sub] = False
            scatter_spans(buf.reshape(-1), src_off[nonfix],
                          sub_lens[nonfix], sub, sub_off[:-1][nonfix])
            scatter_spans(rep_flat, rep_off[:-1], rep_lens,
                          sub, sub_off[:-1][fix_sub])
            if amp_m is not None:
                amp_sub = amp_m[rows] & nonfix
                if amp_sub.any():
                    sub[sub_off[:-1][amp_sub]] = np.uint8(ord("&"))
        else:
            scatter_spans(buf.reshape(-1), src_off, sub_lens,
                          sub, sub_off[:-1])
            if amp_m is not None:
                amp_sub = amp_m[rows]
                if amp_sub.any():
                    sub[sub_off[:-1][amp_sub]] = np.uint8(ord("&"))
        patch_views(views, rows, sub, sub_off, len(variadic))
        variadic.append(pa.py_buffer(sub))
    if ov_rows:
        ov_flat = np.frombuffer(b"".join(ov_vals), dtype=np.uint8)
        ov_off = np.zeros(len(ov_rows) + 1, dtype=np.int64)
        np.cumsum([len(v) for v in ov_vals], out=ov_off[1:])
        patch_views(views, np.asarray(ov_rows), ov_flat, ov_off,
                    len(variadic))
        variadic.append(pa.py_buffer(ov_flat))

    nb = state["null_bitmap"]
    arr = pa.Array.from_buffers(
        pa.string_view(), B,
        [None if nb is None else pa.py_buffer(nb), pa.py_buffer(views)]
        + variadic,
    )
    if not result.ascii_only:
        try:
            arr.validate(full=True)
        except pa.ArrowInvalid:
            return None
    return arr


def _spans_to_view_array(result: "BatchResult", field_id: str):
    """Zero-copy span column -> pa.StringViewArray.

    Arrow's BinaryView layout stores (length, prefix, buffer, offset) per
    element, so clean rows reference the batch's [B, L] byte buffer
    IN PLACE — no gather, no value copy; only the 16-byte view structs
    are built (native lp_build_views).  Rows the buffer bytes cannot
    represent — URI-repair ``fix`` rows, ``amp`` (?->&) rows,
    host-override rows — land in a compact side buffer (repaired via
    _repair_fix_segments) that the views reference as further data
    buffers.  Returns None when the column needs the copy path (non-str
    overrides, >2^31 buffer, or non-UTF-8 values)."""
    import pyarrow as pa

    from ..native import build_views

    B = result.lines_read
    if B == 0:
        return pa.array([], type=pa.string_view())
    buf = np.ascontiguousarray(result.buf[:B])
    if buf.size >= 2**31:
        return None
    pre = _view_column_inputs(result, field_id, buf)
    if pre is None:
        return None
    starts, lens_main, state = pre
    views = build_views(buf, starts[None, :], lens_main[None, :])[0]
    return _assemble_view_array(result, buf, starts, views, state)


def _span_view_arrays(result: "BatchResult", field_ids,
                      pool=None) -> Dict[str, Any]:
    """Batched view materialization: ONE native lp_build_views call
    covers every eligible span column (the per-call thread-pool spawn
    dominated per-column builds), then the per-column side-buffer
    assembly fans out over ``pool`` (tpu/hostpool.py).  Ineligible
    columns are absent."""
    import pyarrow as pa

    from ..native import build_views

    out: Dict[str, Any] = {}
    if not hasattr(pa, "string_view"):
        return out
    B = result.lines_read
    if B == 0:
        return out
    buf = np.ascontiguousarray(result.buf[:B])
    if buf.size >= 2**31:
        return out
    span_fids = [
        fid for fid in field_ids
        if result.column(fid)["kind"] == "span"
    ]
    if not span_fids:
        return out
    # Batched base prep: ONE stacked pass computes valid/starts/lens for
    # every span column (per-column [B] numpy chains added up).  The
    # result is line-invariant per batch, so it is memoized on the
    # BatchResult like the other per-batch decode caches (ascii check,
    # lazy wildcards) — the delivered views themselves are rebuilt on
    # every call.
    pre_cache = result.__dict__.setdefault("_view_pre", {})
    missing = [fid for fid in span_fids if fid not in pre_cache]
    if missing:
        # Batched base prep: ONE stacked pass computes valid/starts/lens
        # for every span column; the per-column pre (incl. special-row
        # masks) is line-invariant per batch and memoized on the
        # BatchResult like the other per-batch decode caches (ascii
        # check, lazy wildcards) — the delivered views and side buffers
        # themselves are rebuilt on every call.
        cols = [result.column(fid) for fid in missing]
        line_valid = np.asarray(result.valid[:B]).astype(bool)
        ok_k = np.stack([np.asarray(c["ok"][:B], dtype=bool) for c in cols])
        null_k = np.stack(
            [np.asarray(c["null"][:B], dtype=bool) for c in cols]
        )
        starts_k = np.stack(
            [np.asarray(c["starts"][:B], dtype=np.int32) for c in cols]
        )
        ends_k = np.stack(
            [np.asarray(c["ends"][:B], dtype=np.int32) for c in cols]
        )
        valid_k = ok_k & ~null_k & line_valid[None, :]
        lens_k = np.where(valid_k, ends_k - starts_k, -1).astype(np.int32)
        for k, fid in enumerate(missing):
            pre_cache[fid] = _view_column_inputs(
                result, fid, buf, base=(valid_k[k], starts_k[k], lens_k[k])
            )
    for fid in span_fids:
        if pre_cache[fid] is None:
            out[fid] = _VIEW_FAILED  # copy path; don't rebuild per column
    pres = [
        (fid, pre_cache[fid]) for fid in span_fids
        if pre_cache[fid] is not None
    ]
    if not pres:
        return out
    # Columns with device-emitted view rows interleave straight from the
    # packed fetch (native streaming pass, no [B, L] buffer traffic); the
    # rest build on host from the stacked starts/lens.  The batched
    # native passes take the pool's full thread budget; the per-column
    # assemblies then fan out over the pool with single-threaded native
    # calls (hostpool contract: the two layers never oversubscribe).
    from .hostpool import MIN_POOLED_ROWS, VIEW_POOL_MIN_WORKERS

    use_pool = (
        pool is not None
        and pool.workers >= VIEW_POOL_MIN_WORKERS
        and B >= MIN_POOLED_ROWS
    )
    n_threads = pool.workers if pool is not None else 0
    task_threads = 1 if use_pool else n_threads
    dev = [p for p in pres if p[0] in result.device_views]
    host = [p for p in pres if p[0] not in result.device_views]
    tasks = []
    task_fids = []
    if dev:
        from ..native import views_interleave

        field_rows = np.asarray(
            [result.device_views[fid] for fid, _ in dev], dtype=np.int64
        )
        dev_views = views_interleave(result.packed, field_rows, B,
                                     buf.shape[1], threads=n_threads)
        if dev_views is None:
            host = pres  # no native library: host-built views for all
        else:
            if result.dirty_view_rows.size:
                dev_views[:, result.dirty_view_rows, :] = 0
            for k, (fid, (st, _lm, state)) in enumerate(dev):
                tasks.append(
                    lambda st=st, v=dev_views[k], state=state:
                    _assemble_view_array(result, buf, st, v, state,
                                         dev_views=True,
                                         threads=task_threads)
                )
                task_fids.append(fid)
    if host:
        starts = np.stack([p[1][0] for p in host])
        lens = np.stack([p[1][1] for p in host])
        views = build_views(buf, starts, lens, threads=n_threads)
        for k, (fid, (st, _lm, state)) in enumerate(host):
            tasks.append(
                lambda st=st, v=views[k], state=state:
                _assemble_view_array(result, buf, st, v, state,
                                     threads=task_threads)
            )
            task_fids.append(fid)
    arrs = pool.run_all(tasks) if use_pool else [t() for t in tasks]
    for fid, arr in zip(task_fids, arrs):
        out[fid] = arr if arr is not None else _VIEW_FAILED
    return out


def _column_to_arrow(
    result: "BatchResult", field_id: str, flat: Optional[Any] = None,
    strings: str = "view", prebuilt: Optional[Any] = None,
):
    import pyarrow as pa

    col = result.column(field_id)
    kind = col["kind"]
    overrides = result._overrides.get(field_id, {})
    B = result.lines_read

    if kind == "span" and not field_id.endswith(".*") and strings == "view":
        if not hasattr(pa, "string_view"):
            # Older pyarrow without the BinaryView type (added in 14,
            # buildable from buffers in 16): classic StringArrays.
            return _column_to_arrow(result, field_id, flat, strings="copy")
        if prebuilt is None:
            # Standalone call (no batched prefetch attempted).
            prebuilt = _spans_to_view_array(result, field_id)
        elif prebuilt is _VIEW_FAILED:
            # The batched pass already tried and failed this column
            # (non-str override / non-UTF-8) — don't rebuild it just to
            # fail the same way.
            prebuilt = None
        if prebuilt is not None:
            return prebuilt
        # Copy-path fallback (non-str overrides / oversized buffer /
        # non-UTF-8): cast string results to string_view so the column
        # type stays stable across batches.
        arr = _column_to_arrow(result, field_id, flat, strings="copy")
        if pa.types.is_string(arr.type):
            arr = arr.cast(pa.string_view())
        return arr

    if kind == "numeric" and not any(
        isinstance(v, (str, dict)) for v in overrides.values()
    ):
        values = np.asarray(col["values"], dtype=np.int64).copy()
        mask = ~(np.asarray(result.valid) & np.asarray(col["ok"]))
        null = np.asarray(col["null"])
        # Per-line CLF-zero semantics: the format that won the line decides
        # whether '-' means 0 (ConvertCLFIntoNumber) or null.
        null_zero = np.asarray(col["null_zero"])
        values[null & null_zero] = 0
        mask = mask | (null & ~null_zero)
        for row, v in overrides.items():
            if v is None or not -2**63 <= v < 2**63:
                # Beyond-int64 oracle values (>18-digit counters) deliver
                # NULL in the typed column — exactly the reference's
                # Long.parseLong null on its Long-typed setters;
                # to_pylist still carries the full python int.
                mask[row] = True
            else:
                values[row] = v
                mask[row] = False
        # Zero-copy wrap: pa.array(values, mask=...) would re-copy the
        # value buffer and rebuild the bitmap.
        nb = _null_bitmap(~mask[:B])
        return pa.Array.from_buffers(
            pa.int64(), B,
            [None if nb is None else pa.py_buffer(nb),
             pa.py_buffer(np.ascontiguousarray(values[:B]))],
        )

    # Device span columns with no host overrides: build the StringArray
    # straight from (offsets, gathered bytes) with numpy — no per-row
    # Python; URI-repair (`fix`) rows are spliced in individually.  Falls
    # through to the slow path for override rows (host fallback),
    # wildcard maps, and non-UTF-8 data.
    if kind == "span" and not field_id.endswith(".*") and not overrides:
        arr = _spans_to_string_array(result, field_id, flat)
        if arr is not None:
            return arr

    # A span column with string overrides (rows the host oracle rescued,
    # decoded values): where the reference builds it row by row, the port
    # casts its view array (the overrides patched in from a side buffer)
    # to a string array -- the same values and nulls, built in C.
    if (kind == "span" and not field_id.endswith(".*") and overrides
            and hasattr(pa, "string_view")):
        if prebuilt is None:
            prebuilt = _spans_to_view_array(result, field_id)
        if prebuilt is not None and prebuilt is not _VIEW_FAILED:
            try:
                return prebuilt.cast(pa.string())
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                pass   # past int32 offsets: the per-row path below

    if field_id.endswith(".*"):
        # Wildcard map columns: the flat CSR buffers build the MapArray
        # directly when possible (no per-row dict materialization at all);
        # the dict path handles the exact-semantics leftovers.
        from .batch import _LazyWildcard

        if isinstance(overrides, _LazyWildcard):
            arr = overrides.to_arrow_map(B)
            if arr is not None:
                return arr
        return pa.array(
            [
                None if v is None else list(v.items())
                for v in result.to_pylist(field_id)
            ],
            type=pa.map_(pa.string(), pa.string()),
        )

    # Host-delivered obj columns (GeoIP range-join results, muid decodes):
    # the values already sit in an object ndarray of Python str/int/float —
    # mask the dead rows vectorized and let pyarrow's C-level inference
    # build the array; only mixed-type columns fall back to the per-row
    # stringify path below.
    if kind == "obj":
        dead = ~(
            np.asarray(result.valid[:B], dtype=bool)
            & np.asarray(col["ok"][:B], dtype=bool)
        )
        # Low-cardinality device-joined strings (GeoIP vocab columns)
        # carry their vocab codes: dictionary.take(codes) builds the
        # string column entirely in C, no per-row inference.
        codes = col.get("dict_codes")
        dvals = col.get("dict_values")
        mixed = col.get("mixed_fill", False)
        if codes is not None and dvals is not None and not mixed \
                and not overrides:
            c = codes[:B].copy()
            c[dead] = -1
            miss = c < 0
            ind = pa.array(
                np.clip(c, 0, None).astype(np.int32),
                mask=miss,
            )
            return _pa_vocab(dvals).take(ind)
        # Numeric geo columns (asn.number, lat/lon confidences) carry
        # their raw typed values + miss mask — same column types as the
        # inference path (int64/double), no per-element work.
        if col.get("typed_kind") and not mixed and not overrides:
            tv = np.asarray(col["typed_values"][:B])
            return pa.array(tv, mask=dead | col["typed_miss"][:B])
        vals = np.asarray(col["values"], dtype=object)[:B]
        if dead.any() or overrides:
            vals = vals.copy()
            vals[dead] = None
            for row, v in overrides.items():
                vals[row] = v
        try:
            arr = pa.array(vals, from_pandas=True)
            # Keep the batch-to-batch schema stable: an all-null batch
            # must stay a string column (as the per-row path types it),
            # not pa.null() — pa.concat_tables across batches depends on
            # it.  Booleans likewise stringify on the per-row path.
            if not (
                pa.types.is_null(arr.type) or pa.types.is_boolean(arr.type)
            ):
                return arr
        except (pa.ArrowInvalid, pa.ArrowTypeError):
            pass  # mixed types: per-row inference below

    # Host-delivered / span columns: type from the materialized values
    # (host-path numerics — e.g. dissector-produced numbers like GeoIP
    # asn.number — must come out int64/float64, not stringified).
    values_py = result.to_pylist(field_id)
    non_null = [v for v in values_py if v is not None]
    if non_null and all(isinstance(v, int) and not isinstance(v, bool) for v in non_null):
        return pa.array(values_py, type=pa.int64())
    if non_null and all(
        isinstance(v, (int, float)) and not isinstance(v, bool) for v in non_null
    ):
        return pa.array(
            [None if v is None else float(v) for v in values_py],
            type=pa.float64(),
        )
    return pa.array(
        [None if v is None else str(v) for v in values_py], type=pa.string()
    )


def batch_to_arrow(
    result: "BatchResult", include_validity: bool = True,
    strings: str = "view", pool=None,
):
    """BatchResult -> pyarrow.Table (one column per requested field).

    ``strings="view"`` (default) delivers span columns as Arrow
    string_view arrays referencing the batch buffer zero-copy — the table
    shares the batch's memory (kept alive by the Arrow buffers).
    ``strings="copy"`` builds classic contiguous StringArrays instead
    (self-contained value buffers).

    ``pool`` (default: the result's attached assembly pool) fans the
    per-column assembly across worker threads: span and numeric columns
    are independent numpy/pyarrow/native work that releases the GIL, so
    they parallelize; wildcard/obj/fallback columns share mutable
    per-result caches and stay on the caller thread.  A 1-wide pool is
    exactly the serial path (thread-count parity is a tested contract)."""
    from ..observability import pipeline_stage

    with pipeline_stage("assembly", items=result.lines_read):
        return _batch_to_arrow(result, include_validity=include_validity,
                               strings=strings, pool=pool)


def _batch_to_arrow(result: "BatchResult", include_validity: bool, strings: str, pool):
    import pyarrow as pa

    from .hostpool import MIN_POOLED_ROWS, VIEW_POOL_MIN_WORKERS

    if pool is None:
        pool = getattr(result, "assembly_pool", None)
    # Mode-dependent engage rule (see hostpool.py): copy-mode
    # columns are one big GIL-released native gather each — they pool
    # from 2 workers; view-mode columns are GIL-holding assembly and
    # need more workers to win.
    pooled = (
        pool is not None
        and result.lines_read >= MIN_POOLED_ROWS
        and pool.workers >= (
            VIEW_POOL_MIN_WORKERS if strings == "view" else 2
        )
    )
    result.ascii_only  # compute the lazy batch-wide check once, serially
    span_fids = [f for f in result.field_ids() if not f.endswith(".*")]
    if strings == "view":
        flats: Dict[str, Any] = {}
        prebuilt = _span_view_arrays(result, span_fids, pool=pool)
    else:
        # Override columns go through their views (see _column_to_arrow).
        prebuilt = _span_view_arrays(
            result, [f for f in span_fids if result._overrides.get(f)], pool=pool)
        if pooled:
            # Per-column gathers fan out over the pool below: each column
            # gathers into its OWN buffer (native threads=1; concurrency
            # comes from the column fan-out), so the per-column re-copy
            # the shared multi-gather buffer forced in
            # _spans_to_string_array disappears.
            flats = {}
        else:
            flats = result.span_bytes_many(span_fids, include_fix=True)

    def build_column(field_id):
        flat = flats.get(field_id)
        if (
            strings == "copy" and pooled and flat is None
            and not field_id.endswith(".*")
            and result.column(field_id)["kind"] == "span"
        ):
            flat = result.span_bytes(field_id, include_fix=True, threads=1)
        return _column_to_arrow(
            result, field_id, flat, strings=strings,
            prebuilt=prebuilt.get(field_id),
        )

    fids = result.field_ids()
    # Columns safe to assemble concurrently: span/numeric device columns
    # (own arrays, read-only shared state).  Wildcard maps (_LazyWildcard
    # materialization), obj columns (shared vocab cache) and anything
    # else run serially on the caller thread.
    parallel_ok = {
        fid for fid in fids
        if not fid.endswith(".*")
        and result.column(fid)["kind"] in ("span", "numeric")
    }
    by_fid: Dict[str, Any] = {}
    if pooled and len(parallel_ok) > 1:
        par = [fid for fid in fids if fid in parallel_ok]
        arrs = pool.run_all(
            [lambda f=fid: build_column(f) for fid in par]
        )
        by_fid.update(zip(par, arrs))
    for field_id in fids:
        if field_id not in by_fid:
            by_fid[field_id] = build_column(field_id)
    arrays = [by_fid[fid] for fid in fids]
    names = list(fids)
    if include_validity:
        arrays.append(pa.array(np.asarray(result.valid, dtype=bool)))
        names.append("__valid__")
    return pa.table(dict(zip(names, arrays)))


def table_to_ipc_bytes(table) -> bytes:
    """Arrow IPC stream serialization (the cross-process/sidecar format)."""
    import pyarrow as pa

    from ..observability import metrics, pipeline_stage

    with pipeline_stage("ipc", items=table.num_rows):
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        out = sink.getvalue()
    metrics().increment("ipc_bytes_out_total", len(out))
    return out


def table_from_ipc_bytes(data: bytes):
    import pyarrow as pa

    with pa.ipc.open_stream(io.BytesIO(data)) as reader:
        return reader.read_all()


def parse_to_ipc(parser, lines) -> bytes:
    """One-call sidecar surface: lines in, Arrow IPC stream bytes out.

    ``lines`` is a sequence of loglines, or a newline-delimited bytes
    blob (routed through the list-free ``parse_blob`` ingest).

    Serialization uses the contiguous copy mode: IPC does not dedupe
    shared buffers, so a string_view table would ship one copy of the
    whole batch buffer PER span column over the wire.  Because no
    string_view column is ever delivered, the device view-row emission
    is skipped too (demand-driven: the view rows would be pure kernel
    and D2H cost on this path)."""
    if isinstance(lines, (bytes, bytearray, memoryview)):
        result = parser.parse_blob(lines, emit_views=False)
    else:
        result = parser.parse_batch(lines, emit_views=False)
    return table_to_ipc_bytes(batch_to_arrow(result, strings="copy"))
