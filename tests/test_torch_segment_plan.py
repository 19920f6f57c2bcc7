"""The segmented reduce's plan of pieces, on the CPU.

On the card the rows are cut at every multiple of R rows: a span longer
than R is reduced by its own block up to the first cut and by one block a
cut from there, and a second launch combines its pieces.
``pieces`` is the plain torch statement of that plan.  These tests hold
that the pieces tile every span exactly, and that the plain version run
over the pieces, then over each span's pieces, equals the one-pass result:
bit-equal for int32 and int64 (wrap-around included), NaN-propagating for
f32 max and min, within 1e-12 relative for f64 sums (the pieces add in
another order).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import segment_reduce as seg

#: rows a piece in these tests (small, so every case runs fast on the CPU)
ROWS = 16


def _spans(kind: str, rows: int = ROWS) -> tuple:
    """(starts, ends, n) of disjoint spans for one edge case."""
    if kind == "empty":  # empty spans among long ones
        lens = [0, 5 * rows + 3, 0, 0, 2 * rows, 0]
    elif kind == "exact":  # spans of exactly R, 2R and R - 1 rows
        lens = [rows, 2 * rows, rows - 1, rows]
    elif kind == "one-over":  # R + 1 rows: one full piece and one row
        lens = [rows + 1, 1, rows + 1, 2 * rows + 1]
    elif kind == "giant":  # half the rows in one span, as chip_smoke.py's
        rng = np.random.default_rng(3)
        small = rng.integers(0, 3 * rows, 40).tolist()
        lens = small[:20] + [sum(small)] + small[20:]
    elif kind == "gaps":  # rows in no span between spans, cuts among them
        lens = [3, rows + 2, 2 * rows, 5, 0, 3 * rows + 1]
        gaps = [rows, 2, rows + 3, 0, 1, 2 * rows]
        ends = np.cumsum(np.add(lens, gaps)).astype(np.int64)
        starts = ends - np.asarray(lens, np.int64)
        return torch.from_numpy(starts), torch.from_numpy(ends), int(ends[-1]) + rows // 2
    else:  # one row a span
        lens = [1] * 37
    ends = np.cumsum(lens).astype(np.int64)
    starts = ends - np.asarray(lens, np.int64)
    return torch.from_numpy(starts), torch.from_numpy(ends), int(ends[-1])


KINDS = ["empty", "exact", "one-over", "giant", "unit", "gaps"]


@pytest.mark.parametrize("kind", KINDS)
def test_pieces_tile_every_span(kind):
    starts, ends, n = _spans(kind)
    span, lo, hi = seg.pieces(starts, ends, n, ROWS)
    assert span.dtype == lo.dtype == hi.dtype == torch.int64
    # one block a span and one a cut cover them
    assert span.shape[0] <= starts.shape[0] + seg.cut_count(n, ROWS)
    for s in range(starts.shape[0]):
        mine = (span == s).nonzero().flatten()
        pl, ph = lo[mine].tolist(), hi[mine].tolist()
        a, b = int(starts[s]), int(ends[s])
        if a == b:
            assert pl == ph == [a]  # the one empty piece: the identity
            continue
        assert pl[0] == a and ph[-1] == b
        assert all(h0 == l1 for h0, l1 in zip(ph[:-1], pl[1:]))  # contiguous
        assert all(0 < h - l <= ROWS for l, h in zip(pl, ph))
        assert all(l % ROWS == 0 for l in pl[1:])  # later pieces start at cuts
        cuts = range(a // ROWS + 1, (b - 1) // ROWS + 1)  # cuts inside the span
        assert len(pl) == (1 + len(cuts) if b - a > ROWS else 1)


def test_giant_span_at_the_kernels_piece_size():
    """2^23 rows of one int64 column in one span: pieces of R rows each."""
    rows = seg.rows_per_piece(1)
    assert rows == seg.PIECE_ELEMS
    n = (1 << 23) + 5
    starts = torch.tensor([0, 1 << 23, n], dtype=torch.int64)
    ends = torch.tensor([1 << 23, n, n], dtype=torch.int64)
    n_pieces = (1 << 23) // rows
    assert seg.cut_count(n, rows) == n_pieces
    span, lo, hi = seg.pieces(starts, ends, n, rows)
    assert torch.bincount(span).tolist() == [n_pieces, 1, 1]
    giant = span == 0
    assert bool((hi[giant] - lo[giant] == rows).all())
    assert lo[giant].max() == (1 << 23) - rows and hi[giant].max() == 1 << 23
    assert seg.cut_count(rows, rows) == 0 and seg.cut_count(rows + 1, rows) == 1
    assert seg.rows_per_piece(8) == seg.PIECE_ELEMS // 8
    assert seg.rows_per_piece(1 << 20) == 1


def _two_pass(vals, starts, ends, op, rows=ROWS):
    span, lo, hi = seg.pieces(starts, ends, vals.shape[0], rows)
    partial = seg.segment_reduce_plain(vals, lo, hi, op)
    order = torch.argsort(span, stable=True)  # each span's pieces together
    counts = torch.bincount(span, minlength=starts.shape[0])
    last = torch.cumsum(counts, 0)
    return seg.segment_reduce_plain(partial[order], last - counts, last, op)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", seg.OPS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_two_passes_equal_one_pass_for_integers(kind, op, dtype):
    """Bit-equal, with sums that wrap around (values near the type's max)."""
    starts, ends, n = _spans(kind)
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(n)
    vals = torch.from_numpy(
        rng.integers(info.max // 4, info.max, (n, 3), dtype=np.int64)
    ).to(dtype)
    vals[::7] = -vals[::7]
    want = seg.segment_reduce_plain(vals, starts, ends, op)
    got = _two_pass(vals, starts, ends, op)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if op == "sum" and kind in ("giant", "one-over"):
        # the case does wrap: the int64 sum differs from NumPy's exact sum
        exact = [int(sum(int(x) for x in vals[a:b, 0].tolist()))
                 for a, b in zip(starts.tolist(), ends.tolist())]
        assert any(e != int(w) for e, w in zip(exact, want[:, 0].tolist()))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["max", "min"])
def test_two_passes_propagate_nan_for_float32(kind, op):
    starts, ends, n = _spans(kind)
    vals = torch.from_numpy(np.random.default_rng(n + 1).standard_normal((n, 2))).float()
    nan_rows = torch.arange(0, n, 23)
    vals[nan_rows, 0] = float("nan")
    want = seg.segment_reduce_plain(vals, starts, ends, op)
    got = _two_pass(vals, starts, ends, op)
    assert bool(want[:, 0].isnan().any())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kind", KINDS)
def test_two_passes_hold_float64_sums_to_1e12(kind):
    starts, ends, n = _spans(kind)
    vals = torch.from_numpy(np.random.default_rng(n + 2).random((n, 4)) * 1e6)
    want = seg.segment_reduce_plain(vals, starts, ends, "sum")
    got = _two_pass(vals, starts, ends, "sum")
    err = float((got - want).abs().max())
    assert err <= 1e-12 * float(want.abs().max())
