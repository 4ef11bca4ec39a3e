"""The port's host compute tier against the JAX package's.

``HostSearcher`` (``DBMT_COMPUTE=host``: the port's own
``csrc/sha256_scan.cpp`` built with ``g++`` into the package's
``build/``) held bit for bit to the JAX ``HostSearcher`` (its committed
native library) and to the ``bitcoin.hash`` oracle on the edge ranges of
ROADMAP queue 3, arg-min and until, at one thread and at several; the
two-phase and batched dispatch; the tier chosen only explicitly; and a
missing ``g++`` raising where the JAX loader answers from its oracle.
"""

import os

import pytest

from distributed_bitcoinminer_tpu.apps.miner import \
    HostSearcher as RefHostSearcher
from distributed_bitcoinminer_tpu.bitcoin.hash import (hash_op, scan_min,
                                                       scan_until)
from distributed_bitcoinminer_tpu_torch.apps import miner
from distributed_bitcoinminer_tpu_torch.apps.miner import HostSearcher
from distributed_bitcoinminer_tpu_torch.ops import sha256_native

U64 = (1 << 64) - 1

#: ROADMAP queue 3's edge ranges: the top of the nonce space, the 19 to
#: 20 digit rollover, 2^63, the empty message and a non-ASCII one.
EDGES = [("cmu440", (1 << 64) - 301, U64),
         ("x", 10 ** 19 - 50, 10 ** 19 + 50),
         ("cmu440", (1 << 63) - 100, (1 << 63) + 100),
         ("", 0, 300),
         ("naïve ✓ 挖矿", 9_990, 10_290)]


def _targets(data, lower, upper):
    """A target only the arg-min meets, one that the nonce a third of the
    way in meets (its first qualifier earlier or there), and one nothing
    meets."""
    best = scan_min(data, lower, upper)[0]
    third = hash_op(data, lower + (upper - lower) // 3)
    return (best + 1, third + 1, 1)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("case", EDGES, ids=lambda c: repr(c[:2]))
def test_host_searcher_equals_jax_and_the_oracle(case, threads):
    data, lower, upper = case
    port = HostSearcher(data, threads=threads)
    ref = RefHostSearcher(data, threads=threads)
    want = scan_min(data, lower, upper)
    assert port.search(lower, upper) == ref.search(lower, upper) == want
    for target in _targets(data, lower, upper):
        want = scan_until(data, lower, upper, target)
        assert port.search_until(lower, upper, target) == \
            ref.search_until(lower, upper, target) == want
    # Ties go to the earliest nonce: a one-nonce range is its own answer.
    assert port.search(upper, upper) == (hash_op(data, upper), upper)


def test_dispatch_and_batch_give_one_pair_per_entry():
    jobs = [(HostSearcher(d), lo, hi) for d, lo, hi in EDGES]
    handle = jobs[0][0].dispatch_batch(jobs)
    assert jobs[0][0].finalize_batch(handle) == \
        [scan_min(d, lo, hi) for d, lo, hi in EDGES]
    s = HostSearcher("cmu440")
    assert s.finalize(s.dispatch(0, 200_000), 0) == \
        RefHostSearcher("cmu440").search(0, 200_000)
    # A batch holding another tier's searcher is not served here.
    assert s.dispatch_batch([(s, 0, 9), (object(), 0, 9)]) is None
    with pytest.raises(ValueError, match="empty range"):
        s.dispatch(5, 4)


def test_library_is_the_ports_own_build():
    lib = sha256_native.load()
    path = sha256_native.library_path()
    assert lib._name == path
    assert os.path.dirname(path) == sha256_native.BUILD_DIR
    assert os.path.basename(path).startswith("libdbmt_native-")
    assert sha256_native.SOURCE.endswith(
        os.path.join("distributed_bitcoinminer_tpu_torch", "csrc",
                     "sha256_scan.cpp"))
    assert os.path.exists(path + ".sha256")


def test_missing_gxx_raises_and_answers_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(sha256_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(sha256_native, "_lib", None)
    monkeypatch.setenv("PATH", "")
    s = HostSearcher("cmu440")
    for call in (lambda: s.search(0, 99), lambda: s.search_until(0, 99, 1),
                 lambda: s.finalize(s.dispatch(0, 99), 0)):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            call()
    assert os.listdir(tmp_path) == []


def test_the_host_tier_is_chosen_only_explicitly(monkeypatch):
    monkeypatch.delenv("DBMT_COMPUTE", raising=False)
    # The card is the default: without one, asking for it raises.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        miner.default_searcher_factory("x")
    assert type(miner.default_searcher_factory("x", "cpu")).__name__ == \
        "NonceSearcher"
    for value in ("host", "HOST", " host "):
        monkeypatch.setenv("DBMT_COMPUTE", value)
        assert isinstance(miner.default_searcher_factory("x"),
                          HostSearcher)
    monkeypatch.setenv("DBMT_COMPUTE", "auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        miner.default_searcher_factory("x")


def test_agents_search_on_the_card_unless_asked(monkeypatch, tmp_path):
    """A miner agent's and a gateway agent's children's searcher: the
    card by default (raising without one, at the CLI's start too), the
    host tier under ``DBMT_COMPUTE=host``."""
    from distributed_bitcoinminer_tpu_torch.apps import procs
    monkeypatch.delenv("DBMT_COMPUTE", raising=False)
    agents = (procs.MinerAgent(str(tmp_path)),
              procs.GatewayAgent(str(tmp_path)))
    for agent in agents:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            agent.factory("x")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        procs._agent_factory(fake=False)
    monkeypatch.setenv("DBMT_COMPUTE", "host")
    for agent in agents:
        assert isinstance(agent.factory("x"), HostSearcher)
    assert isinstance(procs._agent_factory(fake=False)("x"), HostSearcher)
