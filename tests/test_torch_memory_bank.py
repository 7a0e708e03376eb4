"""The port's dual FIFO banks (core/memory_bank.py) against the JAX
package's, push by push on the same numpy rows: buffers, validity, heads and
ages must be identical (a bank is a copy of its rows, no arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memory_bank as jmb
from repro_torch.core import memory_bank as tmb


def _rows(vals, d=4):
    return np.array([np.full((d,), v, np.float32) for v in vals], np.float32).reshape(-1, d)


def _same(tbank, jbank):
    for field in ("buf", "valid", "head", "age"):
        np.testing.assert_array_equal(getattr(tbank, field).numpy(),
                                      np.asarray(getattr(jbank, field)), err_msg=field)


@pytest.mark.parametrize("pushes", [
    [[1, 2], [3, 4], [5]],                      # fill, then wrap one
    [[1, 2, 3, 4, 5]],                          # oversized from head 0
    [[1, 2], [3, 4, 5, 6, 7, 8, 9]],            # oversized from head 2: every slot hit twice
    [[], [1], [2, 3, 4]],                       # an empty push is a no-op
])
def test_push_matches_jax(pushes):
    tb, jb = tmb.init_bank(3, 4, device="cpu"), jmb.init_bank(3, 4)
    for step, vals in enumerate(pushes):
        x = _rows(vals)
        tb = tmb.push(tb, torch.from_numpy(x), step=step + 5)
        jb = jmb.push(jb, jnp.asarray(x), step=step + 5)
        _same(tb, jb)
    np.testing.assert_array_equal(tmb.ordered(tb)[0].numpy(), np.asarray(jmb.ordered(jb)[0]))
    assert int(tmb.n_valid(tb)) == int(jmb.n_valid(jb))


def test_push_is_functional_and_detaches():
    tb = tmb.init_bank(4, 2, device="cpu")
    x = torch.ones(2, 2, requires_grad=True)
    tb2 = tmb.push(tb, x * 3)
    assert not tb.valid.any() and not tb.buf.any()        # the old state is untouched
    assert not tb2.buf.requires_grad and tb2.buf[:2].eq(3).all()


def test_push_pair_clear_and_aligned_valid_match_jax():
    tq, tp = tmb.init_bank(4, 2, device="cpu"), tmb.init_bank(4, 2, device="cpu")
    jq, jp = jmb.init_bank(4, 2), jmb.init_bank(4, 2)
    q, p = _rows([1, 2, 3], 2), _rows([4, 5, 6], 2)
    tq, tp = tmb.push_pair(tq, tp, torch.from_numpy(q), torch.from_numpy(p), step=1)
    jq, jp = jmb.push_pair(jq, jp, jnp.asarray(q), jnp.asarray(p), step=1)
    _same(tq, jq)
    _same(tp, jp)
    np.testing.assert_array_equal(tmb.aligned_valid(tq, tp).numpy(),
                                  np.asarray(jmb.aligned_valid(jq, jp)))
    _same(tmb.clear(tq), jmb.clear(jq))
    reps, valid = tmb.columns_view(tp)
    assert reps is tp.buf and valid is tp.valid
    with pytest.raises(ValueError, match="lockstep"):
        tmb.push_pair(tq, tp, torch.from_numpy(q), torch.from_numpy(p[:2]))


def test_aligned_valid_rejects_unequal_and_disabled_banks():
    a = tmb.init_bank(4, 2, device="cpu")
    with pytest.raises(ValueError, match="equal capacities"):
        tmb.aligned_valid(a, tmb.init_bank(3, 2, device="cpu"))
    none = tmb.aligned_valid(a, tmb.init_bank(0, 2, device="cpu"))
    assert none.shape == (4,) and not none.any()


def test_bank_dtype_is_kept_on_push():
    tb = tmb.init_bank(3, 2, torch.bfloat16, device="cpu")
    tb = tmb.push(tb, torch.full((2, 2), 1.0 / 3.0))
    assert tb.buf.dtype == torch.bfloat16
    assert tb.buf[0, 0].item() == torch.tensor(1.0 / 3.0).to(torch.bfloat16).item()


def _shards(num_shards, cap_local, d=4, dtype=None):
    return [tmb.init_bank(cap_local, d, dtype, device="cpu") for _ in range(num_shards)], \
        [jmb.init_bank(cap_local, d) for _ in range(num_shards)]


@pytest.mark.parametrize("num_shards,cap_local,pushes", [
    (4, 2, [[1, 2, 3], [4, 5, 6, 7, 8], [9]]),          # fill, then wrap across shards
    (2, 3, [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10]]),         # oversized from head 0: newest 6 win
    (3, 2, [[1, 2, 3, 4], [5, 6, 7, 8, 9, 10, 11]]),   # oversized from head 4
    (2, 2, [[], [1], [2, 3, 4, 5, 6]]),                # an empty push is a no-op
])
def test_shard_push_matches_jax_and_its_union_is_a_replicated_push(num_shards, cap_local, pushes):
    """Each shard against JAX's shard_push of the same rows; the shards'
    shard-major union against a replicated push (port and JAX) of the
    whole capacity."""
    tshards, jshards = _shards(num_shards, cap_local)
    tfull = tmb.init_bank(num_shards * cap_local, 4, device="cpu")
    for step, vals in enumerate(pushes):
        x = _rows(vals)
        tshards = [tmb.shard_push(b, torch.from_numpy(x), step=step + 5, shard_index=i,
                                  num_shards=num_shards) for i, b in enumerate(tshards)]
        jshards = [jmb.shard_push(b, jnp.asarray(x), step=step + 5, shard_index=i,
                                  num_shards=num_shards) for i, b in enumerate(jshards)]
        tfull = tmb.push(tfull, torch.from_numpy(x), step=step + 5)
        for tb, jb in zip(tshards, jshards):
            _same(tb, jb)
        for field in ("buf", "valid", "age"):
            union = torch.cat([getattr(b, field) for b in tshards])
            np.testing.assert_array_equal(union.numpy(), getattr(tfull, field).numpy(),
                                          err_msg=field)
        assert all(int(b.head) == int(tfull.head) for b in tshards)
    assert tmb.capacity(tshards[0]) == jmb.capacity(jshards[0]) == cap_local


def test_shard_push_pair_moves_both_banks_in_lockstep():
    tq, jq = _shards(2, 3)
    tp, jp = _shards(2, 3)
    q, p = _rows([1, 2, 3, 4], 4), _rows([5, 6, 7, 8], 4)
    for _ in range(2):
        out_t = [tmb.shard_push_pair(tq[i], tp[i], torch.from_numpy(q), torch.from_numpy(p),
                                     step=3, shard_index=i, num_shards=2) for i in range(2)]
        out_j = [jmb.shard_push_pair(jq[i], jp[i], jnp.asarray(q), jnp.asarray(p),
                                     step=3, shard_index=i, num_shards=2) for i in range(2)]
        tq, tp = [o[0] for o in out_t], [o[1] for o in out_t]
        jq, jp = [o[0] for o in out_j], [o[1] for o in out_j]
        for i in range(2):
            _same(tq[i], jq[i])
            _same(tp[i], jp[i])
            np.testing.assert_array_equal(tq[i].valid.numpy(), tp[i].valid.numpy())
            assert int(tq[i].head) == int(tp[i].head)
    with pytest.raises(ValueError, match="lockstep"):
        tmb.shard_push_pair(tq[0], tp[0], torch.from_numpy(q), torch.from_numpy(p[:2]),
                            shard_index=0, num_shards=2)


def test_shard_push_detaches_and_keeps_the_bank_dtype():
    tb = tmb.init_bank(2, 2, torch.bfloat16, device="cpu")
    x = torch.full((3, 2), 1.0 / 3.0, requires_grad=True)
    out = tmb.shard_push(tb, x * 1.0, shard_index=1, num_shards=2)
    assert out.buf.dtype == torch.bfloat16 and not out.buf.requires_grad
    assert out.valid.tolist() == [True, False] and not tb.valid.any()   # global slots 2 and 3
