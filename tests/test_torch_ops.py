"""The port's hashing ops against the JAX package, bit for bit.

Inputs come from a numpy seed; every comparison is exact (integer hashes,
zero tolerance). The JAX side runs on the CPU: the jnp tier, and the
Pallas kernel in its interpret mode as ``tests/test_pallas.py`` runs it.
The CUDA kernel itself runs only on a card (``gpu`` marker).
"""

import hashlib

import numpy as np
import pytest
import torch

from distributed_bitcoinminer_tpu.bitcoin.hash import hash_op
from distributed_bitcoinminer_tpu.ops import sha256_host as ref_host
from distributed_bitcoinminer_tpu.ops import sha256_jnp as ref_jnp
from distributed_bitcoinminer_tpu.ops.search import search_span
from distributed_bitcoinminer_tpu_torch.ops import search, sha256_cuda
from distributed_bitcoinminer_tpu_torch.ops import sha256_host, sha256_torch

M32 = 0xFFFFFFFF
GRID = [(rem, k) for rem in (0, 1, 3, 4, 31, 32, 55, 56, 62, 63)
        for k in (1, 5, 9)]
_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJ0123 _-",
                         dtype=np.uint8)


def message_for(rem: int, seed: int) -> str:
    """A seeded message whose prefix ``data + " "`` leaves ``rem`` tail
    bytes (one full block absorbed into the midstate when rem < 65)."""
    rng = np.random.default_rng(seed)
    n = 64 + rem - 1
    return bytes(rng.choice(_LETTERS, size=n)).decode()


def plan(data: str, k: int):
    prefix = data.encode() + b" "
    mid, tail = sha256_host.sha256_midstate(prefix)
    return prefix, mid, sha256_torch.build_tail_template(
        tail, k, len(prefix) + k), len(tail)


@pytest.mark.parametrize("rem,k", GRID)
def test_planners_equal_reference(rem, k):
    """The carried host state: midstate, tail template and digit
    placement equal the JAX package's."""
    prefix = message_for(rem, seed=rem * 16 + k).encode() + b" "
    mid, tail = sha256_host.sha256_midstate(prefix)
    rmid, rtail = ref_host.sha256_midstate(prefix)
    assert (mid, tail) == (rmid, rtail) and len(tail) == rem
    got = sha256_torch.build_tail_template(tail, k, len(prefix) + k)
    want = ref_jnp.build_tail_template(tail, k, len(prefix) + k)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sha256_torch.digit_positions(rem, k) == \
        ref_jnp.digit_positions(rem, k)


@pytest.mark.parametrize("rem,k", GRID)
def test_lanes_equal_hash_op(rem, k):
    """Per-lane (hi, lo) of the plain tier equal the hashlib oracle over
    64 seeded k-digit nonces (all 10 for k = 1)."""
    data = message_for(rem, seed=1000 + rem * 16 + k)
    _, mid, tmpl, got_rem = plan(data, k)
    assert got_rem == rem
    rng = np.random.default_rng(rem * 16 + k)
    lo_n = 0 if k == 1 else 10 ** (k - 1)
    nonces = (np.arange(10) if k == 1
              else rng.integers(lo_n, 10 ** k, size=64))
    i = torch.as_tensor(nonces, dtype=torch.int64)
    hi, lo = sha256_torch.hash_lanes(mid, tmpl, i, rem, k)
    want = [hash_op(data, int(n)) for n in nonces]
    assert hi.tolist() == [h >> 32 for h in want]
    assert lo.tolist() == [h & M32 for h in want]


def _ref_span(mid, tmpl, i0, lo_i, hi_i, rem, k, batch, nbatches):
    out = search_span(np.asarray(mid, np.uint32), tmpl, np.uint32(i0),
                      np.uint32(lo_i), np.uint32(hi_i), None, rem=rem, k=k,
                      batch=batch, nbatches=nbatches)
    return tuple(int(x) for x in out)


def _port_span(mid, tmpl, i0, lo_i, hi_i, rem, k, n, chunk):
    out = search.span_scan(mid, tmpl, i0, lo_i, hi_i, n, rem=rem, k=k,
                           device="cpu", chunk=chunk)
    return tuple(int(x) for x in out.tolist())


@pytest.mark.parametrize("name,data,k,i0,lo_i,hi_i,batch,nbatches", [
    ("masked", "cmu440", 6, 4096, 4100, 4500, 512, 1),
    ("multi_step", "multi step span", 7, 1_000_000, 1_000_033, 1_001_900,
     256, 8),
    ("two_block_tail", "x" * 60, 9, 123_000_000, 123_000_005,
     123_000_250, 128, 2),
])
def test_span_scan_equals_jnp_search_span(name, data, k, i0, lo_i, hi_i,
                                          batch, nbatches):
    _, mid, tmpl, rem = plan(data, k)
    assert (tmpl.shape[0] == 2) == (name == "two_block_tail")
    want = _ref_span(mid, tmpl, i0, lo_i, hi_i, rem, k, batch, nbatches)
    got = _port_span(mid, tmpl, i0, lo_i, hi_i, rem, k, batch * nbatches,
                     chunk=batch)
    assert got == want


def test_span_scan_equals_pallas_interpret():
    """The Pallas kernel (K1) in interpret mode, rows=1, nsteps=2 — the
    geometry tests/test_pallas.py runs."""
    from distributed_bitcoinminer_tpu.ops.sha256_pallas import \
        pallas_search_span
    _, mid, tmpl, rem = plan("pallas parity", 5)
    i0, lo_i, hi_i = 20_000, 20_007, 20_200
    out = pallas_search_span(np.asarray(mid, np.uint32), tmpl,
                             np.uint32(i0), np.uint32(lo_i),
                             np.uint32(hi_i), rem=rem, k=5, rows=1,
                             nsteps=2, interpret=True)
    want = tuple(int(x) for x in out)
    assert _port_span(mid, tmpl, i0, lo_i, hi_i, rem, 5, 256, 100) == want


def test_lex_argmin_tie_rule_matches_reference():
    rng = np.random.default_rng(7)
    for trial in range(4):
        hi = rng.integers(0, 3, size=97).astype(np.uint32)
        lo = rng.integers(0, 2, size=97).astype(np.uint32)
        idx = rng.permutation(97).astype(np.uint32)
        if trial == 3:      # an all-ones hash on a valid lane
            hi[:] = M32
            lo[:] = M32
        want = tuple(int(x) for x in ref_jnp.lex_argmin(hi, lo, idx))
        got = sha256_torch.lex_argmin(
            *(torch.as_tensor(a.astype(np.int64)) for a in (hi, lo, idx)))
        assert tuple(int(x) for x in got) == want


def test_span_scan_empty_window_and_single_lane():
    """An empty window returns the sentinel; a one-lane window returns
    that lane's oracle hash."""
    _, mid, tmpl, rem = plan("edge", 3)
    assert _port_span(mid, tmpl, 10, 20, 19, rem, 3, 40, 16) == (M32,) * 3
    got = _port_span(mid, tmpl, 0, 123, 123, rem, 3, 1000, 64)
    h = hash_op("edge", 123)
    assert got == (h >> 32, h & M32, 123)


def test_span_argmin_cpu_runs_plain_and_launches_no_kernel():
    sha256_cuda.reset_launches()
    _, mid, tmpl, rem = plan("routing", 4)
    got = search.span_argmin(mid, tmpl, 0, 1000, 9999, 9000, rem=rem, k=4,
                             device="cpu")
    want = search.span_scan(mid, tmpl, 0, 1000, 9999, 9000, rem=rem, k=4,
                            device="cpu")
    assert got.tolist() == want.tolist()
    assert sha256_cuda.total_launches() == 0
    with pytest.raises(ValueError):
        search.span_argmin(mid, tmpl, 0, 0, 9, 10, rem=rem, k=4,
                           device="meta")


def test_kernel_wrapper_refuses_cpu():
    _, mid, tmpl, rem = plan("no fallback", 2)
    with pytest.raises(ValueError):
        sha256_cuda.sha256_argmin(mid, tmpl, 0, 0, 99, 100, rem=rem, k=2,
                                  device="cpu")
    with pytest.raises(ValueError):
        sha256_cuda.sha256_argmin(mid, tmpl, 0, 0, 99, 100, rem=rem, k=2,
                                  device=torch.empty(3).device)
    assert sha256_cuda.total_launches() == 0


def test_plan_words_layout():
    """The kernels' by-value parameter block: midstate, 32 template words
    (zero-padded for 1-block tails), then rem, k, nblocks, i0, lo, hi, n
    and the target's two words (0 unless given)."""
    for data, k in (("cmu440", 9), ("y" * 60, 9)):
        _, mid, tmpl, rem = plan(data, k)
        words = sha256_cuda.plan_array(mid, tmpl, 5, 6, 7, 8, rem,
                                       k).tolist()
        nb = tmpl.shape[0]
        assert len(words) == sha256_cuda.PLAN_WORDS == 49
        assert words[:8] == list(mid)
        assert words[8:8 + 16 * nb] == [int(x) for x in tmpl.reshape(-1)]
        assert words[8 + 16 * nb:40] == [0] * (16 * (2 - nb))
        assert words[40:] == [rem, k, nb, 5, 6, 7, 8, 0, 0]
        assert sha256_cuda.plan_array(mid, tmpl, 5, 6, 7, 8, rem, k, 9,
                                      10)[47:].tolist() == [9, 10]


@pytest.mark.gpu
def test_kernel_equals_plain_on_card():
    """The CUDA kernel against the plain scan on the card, 1- and 2-block
    tails, with valid edges off the thread and block edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py on the GPU)")
    dev = torch.device("cuda", 0)
    for data, k, i0, n in (("cmu440", 9, 100_000_000, (1 << 18) + 77),
                           ("z" * 60, 9, 5_000_000, (1 << 18) + 5),
                           ("z" * 60, 2, 0, 100)):
        _, mid, tmpl, rem = plan(data, k)
        lo_i, hi_i = i0 + 3, i0 + n - 7
        got = sha256_cuda.sha256_argmin(mid, tmpl, i0, lo_i, hi_i, n,
                                        rem=rem, k=k, device=dev)
        want = search.span_scan(mid, tmpl, i0, lo_i, hi_i, n, rem=rem, k=k,
                                device=dev)
        got = [int(x) & M32 for x in got.tolist()]
        assert got == want.tolist()
        prefix = data.encode() + b" "
        digest = hashlib.sha256(prefix + f"{got[2]:0{k}d}".encode()).digest()
        assert got[:2] == [int.from_bytes(digest[:4], "big"),
                           int.from_bytes(digest[4:8], "big")]
