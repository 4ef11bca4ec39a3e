"""The port's NonceSearcher against the JAX searcher and the hashlib oracle.

Exact comparisons (integer hash, nonce) on three ranges: one across digit
classes 1-5, one across an aligned 10^9 block boundary, and one whose
message puts every nonce's digits into a second tail block. The port runs
with ``device="cpu"`` (its plain scan); the JAX searcher runs its jnp tier
on the CPU.
"""

import pytest
import torch

from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min
from distributed_bitcoinminer_tpu.models.miner_model import \
    NonceSearcher as RefSearcher
from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
from distributed_bitcoinminer_tpu_torch.ops import searchop, sha256_cuda

RANGES = [
    # (name, data, lower, upper, blocks)
    ("digit_classes_1_to_5", "cmu440", 0, 10_300, 5),
    ("block_boundary", "cmu440", 1_999_999_500, 2_000_000_400, 2),
    ("two_block_tail", "y" * 60, 9_950, 10_100, 2),
]


@pytest.mark.parametrize("name,data,lower,upper,blocks", RANGES)
def test_searcher_equals_jax_and_oracle(name, data, lower, upper, blocks,
                                       monkeypatch):
    sha256_cuda.reset_launches()
    got = NonceSearcher(data, device="cpu").search(lower, upper)
    assert got == scan_min(data, lower, upper)
    # The JAX stock path with one step per block: one jit signature per
    # (rem, k), the cheapest way to run its jnp tier here.
    monkeypatch.setenv("DBM_DEVLOOP", "0")
    ref = RefSearcher(data, batch=16384, tier="jnp", hoist=False)
    assert got == ref.search(lower, upper)
    assert sha256_cuda.total_launches() == 0  # the CPU path ran no kernel


@pytest.mark.parametrize("name,data,lower,upper,blocks", RANGES)
def test_dispatch_finalize_equals_search_one_launch_per_block(
        name, data, lower, upper, blocks):
    s = NonceSearcher(data, device="cpu")
    handle = s.dispatch(lower, upper)
    assert s.device_launches == blocks == len(list(s.plan(lower, upper)))
    assert s.finalize(handle, lower) == s.search(lower, upper)
    assert s.device_launches == 2 * blocks


def test_top_digits_join_the_midstate():
    """Nonces >= 10^9 put their top digits into the host prefix; the
    midstate cache keys on them."""
    s = NonceSearcher("cmu440", device="cpu")
    plans = list(s.plan(12_345_678_900, 12_345_679_050))
    assert [(p.base, p.k) for p in plans] == [(12_000_000_000, 9)]
    assert ("12", 9) in s._midstate_cache
    assert s.search(12_345_678_900, 12_345_679_050) == \
        scan_min("cmu440", 12_345_678_900, 12_345_679_050)


def test_empty_range_raises_and_finalize_skips_sentinels():
    s = NonceSearcher("cmu440", device="cpu")
    with pytest.raises(ValueError):
        s.dispatch(10, 9)
    # A block without a valid lane folds its all-ones sentinel into the
    # span's carry, which must keep nothing of it.
    carry = searchop.fold_argmin(searchop.carry_init(), *[0xFFFFFFFF] * 3,
                                 0, 0)
    assert s.finalize(carry, 7) == ((1 << 64) - 1, 7)


def test_no_gpu_raises_never_falls_back(monkeypatch):
    """With no CUDA device the default searcher (cuda) refuses to build;
    it never quietly searches on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        NonceSearcher("cmu440")
    with pytest.raises(RuntimeError):
        NonceSearcher("cmu440", device="cuda:0")
    with pytest.raises(ValueError):
        NonceSearcher("cmu440", device="meta")
