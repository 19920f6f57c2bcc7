"""Sequence parallelism and sharded serving, on 8 gloo CPU ranks.

``repro``'s default plan (the one the dry run places every cell with)
splits the sequence over ``model`` between layers and, for decode, drops
that split.  Each of ``SEQ_PARALLEL``'s reduced archs starts from
``repro``'s seeded parameters (``PRNGKey(0)``, laid out as the port's by
``interop``) and ``sharded_ranks._family_batch``.  The ranks are spawned
once for the file (the target, ``sharded_ranks.seq_parallel_steps``): in
f32, and in f64 with the f32 islands lifted, on a (data 2, model 4) mesh
under that plan, each arch takes one train step and a prefill with the
sequence split, then a prefill and a decode step without it.  Held
against:

* ``repro``'s own sharded computations of the same config, parameters and
  batch on the same (2, 4) mesh and plans (8 forced host devices, one
  subprocess for the file), in f64: the loss, the gradient norm, each
  parameter's gradient norm (a stacked leaf of ``repro``'s taken layer by
  layer) and the logits within ``EXACT_RTOL`` (the two lie at most 4e-11
  apart);
* the same in f32, by ``tests/train_parity.py``'s rule: the loss and the
  gradient norm within rtol 1e-5, the logits within rtol 1e-4 and 1e-4 x
  their largest magnitude; or ten times how far ``repro``'s f32 number
  lies from its exact (f64) one, whichever is looser.  A parameter's
  gradient norm is held in f64 only: the reduced models' f32 gradients
  are ill-conditioned (seamless's f32 gradient norm lies 4 % from its f64
  one), and the port's f32 rounding differs from XLA's leaf by leaf;
* the port's same f32 computations on one device, by the same rules with
  the port's one-device f32 and f64 standing in for ``repro``'s.
"""

import pytest

import sharded_ranks
import seq_parallel_parity as SP

ARCHS = list(sharded_ranks.SEQ_PARALLEL)
#: how far the port's f64 computations may lie from repro's (relative)
EXACT_RTOL = SP.EXACT_RTOL


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each arch's parameters (``repro``'s leaves, and the port's state
    dict) and batch, saved for the ranks and the ``repro`` subprocess."""
    return SP.make_inputs(tmp_path_factory.mktemp("seq_parallel"),
                          sharded_ranks.SEQ_PARALLEL)


@pytest.fixture(scope="module")
def sharded(inputs):
    return SP.run_sharded(inputs)


@pytest.fixture(scope="module")
def reference(inputs):
    """arch -> dtype -> repro's loss, gradient norm, each parameter's
    gradient norm (by the port's names), prefill and decode logits."""
    return SP.run_reference(inputs)


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_step_and_sharded_decode_match_one_device(inputs, sharded, arch):
    got = sharded[arch, "float32"]
    want = SP.one_device(inputs, arch)
    exact = SP.one_device(inputs, arch, exact=True)
    SP.check_scalars(got, want, exact)
    SP.check_logits(got, want, exact)


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_train_step_matches_repro(sharded, reference, arch):
    SP.check_scalars(sharded[arch, "float32"], reference[arch, "float32"],
                     reference[arch, "float64"])
    SP.check_exact(sharded[arch, "float64"], reference[arch, "float64"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_prefill_and_sharded_decode_match_repro(sharded, reference, arch):
    SP.check_logits(sharded[arch, "float32"], reference[arch, "float32"],
                    reference[arch, "float64"])
