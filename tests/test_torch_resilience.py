"""Resilience layer of the PyTorch port against the JAX package on the same
inputs: the retry schedule, the seeded fault injector's fire sequences
(the serving fleet's chaos schedules depend on them), crash-consistent
checkpoint IO, and the preemption drain (signal handlers and the resume
bundle)."""
import os
import pickle
import signal
import time

import pytest
import torch

from incubator_mxnet_tpu import resilience as jres
from incubator_mxnet_tpu.resilience import fault as jfault
from incubator_mxnet_tpu_torch import random as trandom
from incubator_mxnet_tpu_torch import resilience as tres
from incubator_mxnet_tpu_torch.resilience import fault as tfault
from incubator_mxnet_tpu_torch.resilience import preemption as tpre


@pytest.fixture(autouse=True)
def _clean_state():
    """No-op injectors resolved and no drain handler installed, before
    and after every test, in both packages."""
    for f in (jfault, tfault):
        f.install(None)
    tpre.uninstall()
    tpre.reset()
    yield
    for f in (jfault, tfault):
        f.install(None)
    tpre.uninstall()
    tpre.reset()


# -- retry ---------------------------------------------------------------------

RETRY_FIELDS = [
    dict(max_attempts=6, seed=11),
    dict(max_attempts=10, base_delay=0.1, max_delay=0.4, jitter=0.0, seed=0),
    dict(max_attempts=8, base_delay=0.05, max_delay=2.0, jitter=0.3, seed=7),
    dict(max_attempts=1, seed=3),
]


@pytest.mark.parametrize("fields", RETRY_FIELDS,
                         ids=[f"policy{i}" for i in range(len(RETRY_FIELDS))])
def test_retry_delays_equal_jax(fields):
    got = list(tres.RetryPolicy(**fields).delays())
    want = list(jres.RetryPolicy(**fields).delays())
    assert got == want
    assert len(got) == max(0, fields["max_attempts"] - 1)


def test_retry_from_knobs_equal_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_RETRY_MAX_ATTEMPTS", "5")
    monkeypatch.setenv("MXTPU_RETRY_BASE_DELAY", "0.25")
    monkeypatch.setenv("MXTPU_RETRY_JITTER", "0.2")
    got, want = tres.RetryPolicy.from_knobs(), jres.RetryPolicy.from_knobs()
    assert got == tres.RetryPolicy(**vars(want))
    assert list(got.delays()) == list(want.delays())
    assert tres.RetryPolicy.from_knobs(max_attempts=9).max_attempts == 9
    for knob in ("MXTPU_RETRY_MAX_ATTEMPTS", "MXTPU_RETRY_BASE_DELAY",
                 "MXTPU_RETRY_JITTER"):
        monkeypatch.delenv(knob)
    assert tres.RetryPolicy.from_knobs() == tres.RetryPolicy(
        **vars(jres.RetryPolicy.from_knobs()))


@pytest.mark.parametrize("case", ["succeeds", "exhausts", "other_error"])
def test_retry_call_attempts_equal_jax(case):
    def run(pkg):
        p = pkg.RetryPolicy(max_attempts=3, base_delay=0.001,
                            max_delay=0.002, deadline=5.0, seed=0)
        attempts = []

        def fn(k):
            attempts.append(k)
            if case == "other_error":
                raise ValueError("not retryable")
            if case == "exhausts" or k < 2:
                raise ConnectionError("flaky")
            return "done"

        try:
            out = p.call(fn, ConnectionError, site="test")
        except (ConnectionError, ValueError) as e:
            out = type(e).__name__
        return out, attempts

    assert run(tres) == run(jres)


# -- fault injection -----------------------------------------------------------

# (spec, seed, instances): the pinned chaos schedule of the serving fleet,
# probabilistic and indexed drops/fails/torn writes, and every delay form
FAULT_CASES = {
    "replica_kill_pinned": ("replica.kill:fail@0.005", 138,
                            ("r1", "r2", "r3")),
    "rpc_drop": ("ps.rpc:drop@0.3", 5, ("w0", "w1")),
    "indexed": ("ckpt.write:fail@2;s:torn@1,3", 0, ("",)),
    "gateway_accept": ("gateway.accept:fail@0.1", 9, ("",)),
    "sigterm": ("train.step:sigterm@5,500", 2, ("",)),
    "delay_every": ("c:delay@7", 1, ("", "x")),
    "delay_indices": ("b:delay@50x3,4,999", 0, ("",)),
    "delay_prob": ("net.hop:delay@1x0.5", 4, ("w0", "w1")),
    "rpc_mixed": ("replica.rpc:delay@2x0.01;replica.kill:fail@0.001", 17,
                  ("r1", "r2")),
}


@pytest.mark.parametrize("name", sorted(FAULT_CASES))
def test_fault_fire_sequences_equal_jax(name):
    spec, seed, instances = FAULT_CASES[name]
    port, ref = tfault.FaultInjector(spec, seed), jfault.FaultInjector(spec,
                                                                       seed)
    sites = [part.split(":")[0] for part in spec.split(";")]
    for site in sites:
        for inst in instances:
            got = [port.action(site, inst) for _ in range(1000)]
            want = [ref.action(site, inst) for _ in range(1000)]
            assert got == want, (site, inst)
    assert port.stats() == ref.stats()
    assert port.delay_ms(sites[0]) == ref.delay_ms(sites[0])


def test_pinned_kill_schedule_first_fires():
    """The fleet's failover chaos leg relies on this schedule: r1 dies
    first at pump 6, r2 at 522 and the replacement r3 at 313."""
    inj = tfault.FaultInjector("replica.kill:fail@0.005", seed=138)
    first = {}
    for inst in ("r1", "r2", "r3"):
        seq = [inj.action("replica.kill", inst) for _ in range(600)]
        first[inst] = seq.index("fail") + 1
    assert first == {"r1": 6, "r2": 522, "r3": 313}


@pytest.mark.parametrize("bad", [
    "nonsense", "a:b", "s:drop@oops", "s:drop@1.5", "s:explode@1",
    "s:fail@0", "a:drop@0.1;a:fail@2", "s:delay@oops", "s:delay@-5",
    "s:delay@", "s:delay@5x"])
def test_fault_spec_errors_equal_jax(bad):
    with pytest.raises(ValueError) as got:
        tfault.FaultInjector(bad)
    with pytest.raises(ValueError) as want:
        jfault.FaultInjector(bad)
    assert str(got.value) == str(want.value)


def test_fault_raise_for_and_sleep_for():
    inj = tfault.FaultInjector("a:drop@1;b:fail@1;slow:delay@20", seed=0)
    with pytest.raises(ConnectionError):
        inj.raise_for("a")
    with pytest.raises(OSError):
        inj.raise_for("b")
    assert inj.raise_for("unknown.site") is None
    t0 = time.monotonic()
    assert inj.sleep_for("slow") == "delay"
    assert inj.raise_for("slow") == "delay"
    assert time.monotonic() - t0 >= 0.035
    assert inj.fired("slow", mode="delay") == 2
    assert inj.sleep_for("other.site") is None


def test_injector_resolves_from_env(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "x.y:fail@1")
    monkeypatch.setenv("MXTPU_FAULT_SEED", "9")
    inj = tfault.refresh_from_env()
    assert inj.active and inj.seed == 9
    assert tfault.injector() is inj
    monkeypatch.delenv("MXTPU_FAULT_SPEC")
    assert not tfault.refresh_from_env().active


# -- crash-consistent checkpoint IO --------------------------------------------

def _checkpoint_case(pkg, fault_mod, d, case):
    """Run one checkpoint scenario with package `pkg` in directory `d`;
    returns what a caller can observe: the file, its manifest, verify()."""
    p = str(d / "w.params")
    if case == "legacy":
        with open(p, "wb") as f:
            f.write(b"pre-resilience bytes")
    else:
        pkg.atomic_write_bytes(p, b"0123456789" * 7)
    outcome = None
    if case == "corrupt":
        with open(p, "r+b") as f:  # flip a byte, size unchanged
            f.seek(3)
            f.write(b"X")
    elif case == "truncate":
        with open(p, "r+b") as f:
            f.truncate(4)
    elif case in ("fail", "torn"):
        fault_mod.install(fault_mod.FaultInjector(f"ckpt.write:{case}@1", 0))
        try:
            pkg.atomic_write_bytes(p, b"A" * 100)
        except OSError as e:
            outcome = type(e).__name__
        fault_mod.install(None)
    with open(p, "rb") as f:
        data = f.read()
    leftovers = sorted(x for x in os.listdir(d) if ".tmp." in x)
    return (data, pkg.read_manifest(p), pkg.verify(p), outcome, leftovers,
            pkg.verify(str(d / "missing.params")))


@pytest.mark.parametrize("case", ["roundtrip", "corrupt", "truncate",
                                  "legacy", "fail", "torn"])
def test_checkpoint_equal_jax(case, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _checkpoint_case(tres, tfault, tmp_path / "port", case)
    want = _checkpoint_case(jres, jfault, tmp_path / "jax", case)
    assert got == want
    ok = {"roundtrip": True, "corrupt": False, "truncate": False,
          "legacy": True, "fail": True, "torn": False}[case]
    assert got[2] is ok
    if case == "fail":  # the previous payload survives a failed write
        assert got[0] == b"0123456789" * 7 and got[3] == "InjectedIOError"
    if case == "torn":  # truncated canonical file, full-size manifest
        assert len(got[0]) == 50 and got[1]["size"] == 100


# -- preemption ----------------------------------------------------------------

class _StubNet:
    """Duck-typed `save_parameters(path)`: the port's gluon has no
    parameter files yet."""

    def __init__(self, payload):
        self.payload = payload

    def save_parameters(self, path):
        with open(path, "wb") as f:
            f.write(self.payload)


class _StubTrainer:
    """Duck-typed `save_states(path)`, written as the JAX Trainer does:
    through the crash-consistent writer."""

    def __init__(self, payload):
        self.payload = payload

    def save_states(self, path):
        tres.atomic_write_bytes(path, self.payload)


class _StubLoader:
    def state_dict(self):
        return {"epoch_seed": 3, "cursor": 5}


def test_bundle_write_read_clear(tmp_path):
    prefix = str(tmp_path / "run")
    trandom.seed(5)
    trandom.next_key()
    rng = trandom.get_state()
    bundle = tpre.write_bundle(prefix, trainer=_StubTrainer(b"states"),
                               net=_StubNet(b"params"), loader=_StubLoader(),
                               epoch=7)
    assert bundle == tpre.bundle_paths(prefix)[0]
    trandom.seed(999)
    got = tpre.read_bundle(prefix)
    assert got["epoch"] == 7 and got["version"] == 1
    assert got["has_params"] and got["has_states"]
    assert got["loader"] == {"epoch_seed": 3, "cursor": 5}
    assert got["rng"] == {"seed": 5, "counter": 1}
    trandom.set_state(got["rng"])
    assert trandom.get_state() == rng
    _, params, states = tpre.bundle_paths(prefix)
    assert open(params, "rb").read() == b"params"
    assert open(states, "rb").read() == b"states"
    for path in tpre.bundle_paths(prefix):
        assert tres.verify(path)
    tpre.clear_bundle(prefix)
    assert tpre.read_bundle(prefix) is None
    for p in tpre.bundle_paths(prefix):
        assert not os.path.exists(p)
        assert not os.path.exists(tres.manifest_path(p))


@pytest.mark.parametrize("damage", ["bundle_bytes", "no_manifest",
                                    "params_bytes"])
def test_bundle_rejects_damage(damage, tmp_path):
    prefix = str(tmp_path / "run")
    tpre.write_bundle(prefix, net=_StubNet(b"params" * 10), epoch=2)
    bundle, params, _ = tpre.bundle_paths(prefix)
    if damage == "bundle_bytes":
        with open(bundle, "r+b") as f:
            f.write(b"\xff\xff\xff")
    elif damage == "no_manifest":  # no legacy loophole for a bundle
        os.remove(tres.manifest_path(bundle))
    else:
        with open(params, "r+b") as f:
            f.truncate(3)
    assert tpre.read_bundle(prefix) is None


def test_bundle_layout_equal_jax(tmp_path):
    """The same descriptor keys, payload files and generator position
    ({"seed", "counter"}) as the JAX bundle."""
    from incubator_mxnet_tpu import random as jrandom
    from incubator_mxnet_tpu.resilience import preemption as jpre
    trandom.seed(3)
    jrandom.seed(3)
    for _ in range(2):
        trandom.next_key()
        jrandom.next_key()
    tpre.write_bundle(str(tmp_path / "port"), net=_StubNet(b"p"), epoch=4)
    jpre.write_bundle(str(tmp_path / "jax"), net=_StubNet(b"p"), epoch=4)
    got = tpre.read_bundle(str(tmp_path / "port"))
    want = jpre.read_bundle(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    assert got == want
    assert got["rng"] == {"seed": 3, "counter": 2}


def test_sigterm_sets_requested_then_escalates():
    tpre.install()
    assert not tpre.requested()
    os.kill(os.getpid(), signal.SIGTERM)
    assert tpre.requested()
    with pytest.raises(tpre.Preempted) as ei:
        os.kill(os.getpid(), signal.SIGTERM)  # second signal escalates
    assert ei.value.code == tpre.PREEMPTED_EXIT_CODE == 83


def test_sigterm_chains_previous_handler():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        tpre.install()
        os.kill(os.getpid(), signal.SIGTERM)
        assert hits == [signal.SIGTERM]
        assert tpre.requested()
    finally:
        tpre.uninstall()
        signal.signal(signal.SIGTERM, prev)


def test_checkpoint_and_exit_drains_with_code_83(tmp_path):
    prefix = str(tmp_path / "run")
    tpre.install()
    assert tpre.maybe_checkpoint_and_exit(prefix) is None  # no signal yet
    os.kill(os.getpid(), signal.SIGTERM)

    class _Kv:
        left = False

        def leave(self):
            self.left = True

    kv = _Kv()
    with pytest.raises(tpre.Preempted) as ei:
        tpre.maybe_checkpoint_and_exit(prefix, net=_StubNet(b"w"), epoch=3,
                                       kv=kv)
    assert ei.value.code == 83 and kv.left
    assert tpre.read_bundle(prefix)["epoch"] == 3
