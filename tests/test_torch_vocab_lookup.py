"""The vocab-parallel embedding lookup (``context.embedding``) on 8 gloo
CPU ranks, against the whole table's lookup.

Each case of ``sharded_ranks.LOOKUP_CASES`` looks a seeded 8 x 8 batch of
tokens up in a seeded f32 table split as its plan splits it: over
``model`` with the sequence whole or split, with a vocab that ``model``
splits unevenly, and with the table's ``embed`` over ``data`` or over
``("pod", "data")`` on a (2, 2, 2) mesh (FSDP: the tokens gathered, the
columns turned into rows by all-to-alls).  The forward must equal the
whole table's lookup bit for bit (each reduction adds one row to zeros)
and lie as the plan places the residual stream; the table's gradient
(each rank's scatter-add into its rows, partial over the data axes where
the table is replicated there) must match the whole table's within f32
summation order (atol 1e-5 for sums of O(1) terms).
"""

import pytest

import sharded_ranks
from repro_torch.core.ranks import run_ranks

CASES = list(sharded_ranks.LOOKUP_CASES)


@pytest.fixture(scope="module")
def looked_up():
    return run_ranks(sharded_ranks.lookup_cases, 8, backend="gloo", timeout_s=120)


@pytest.mark.parametrize("case", CASES)
def test_lookup_equals_the_whole_tables(looked_up, case):
    equal, placed, grad_err = looked_up[case]
    assert equal and placed
    assert grad_err < 1e-5, grad_err
