"""The port's Correlator state machine against ``fxtpu``'s: the mutations
that rebuild the engine and the ones it refuses.

``nbins`` may change while no stager runs (the engine is rebuilt at the
new bin count), and not while the device stager runs: its batches are
framed by the old engine's ``prepare_batch`` and would reach the new
step mis-framed (``fxtpu/correlator.py:338-342``).  Each case runs for
both packages; the JAX package is imported inside the case that needs
it, so that this file runs on a machine without JAX."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

SMALL = dict(num_samp=2**13, nbins=256, clamp_num_samp=False, run_time=60,
             startup_duration=0.1, loglevel="WARNING", fused=True,
             blocks_per_dispatch=4)


def _correlator(pkg, tmp_path):
    """A Correlator of ``pkg`` over a noise source, K = 4 blocks a call
    (the staged path), nothing started."""
    if pkg == "fxtpu":
        pytest.importorskip("jax")
        from fxtpu.config import CorrelatorConfig
        from fxtpu.correlator import Correlator
        from fxtpu.sources import NoiseSource
        cfg = CorrelatorConfig(**SMALL, output_file=str(tmp_path / "v.csv"))
    else:
        from fxtpu_torch.config import CorrelatorConfig
        from fxtpu_torch.correlator import Correlator
        from fxtpu_torch.sources import NoiseSource
        cfg = CorrelatorConfig(**SMALL, output_file=str(tmp_path / "v.csv"),
                               device="cpu")
    return Correlator(config=cfg, source=NoiseSource(nchan=2, seed=3))


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_nbins_changes_without_a_stager(pkg, tmp_path):
    cor = _correlator(pkg, tmp_path)
    try:
        assert cor.stager is None
        old = cor.engine
        cor.nbins = 512
        assert cor.engine is not old
        assert cor.config.nbins == cor.engine.cfg.nbins == 512
        assert cor.history is not None
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_nbins_change_refused_while_the_stager_runs(pkg, tmp_path):
    cor = _correlator(pkg, tmp_path)
    try:
        cor._maybe_start_stager()
        assert cor.stager is not None
        engine = cor.engine
        with pytest.raises(RuntimeError, match="nbins cannot change while "
                                               "the async stager is running"):
            cor.nbins = 512
        assert cor.engine is engine
        assert cor.config.nbins == engine.cfg.nbins == 256
    finally:
        cor.close()


# --------------------------------------------------------------------------
# The setters and the mutations that rebuild the engine
# (tests/test_state_machine.py), each for both packages
# --------------------------------------------------------------------------

def _make(pkg, mesh=None, **kw):
    """A Correlator of ``pkg`` at fxtpu's test defaults (2^14 samples,
    1024 bins), on the CPU, optionally over a (t, f) mesh of its own."""
    kw.setdefault("num_samp", 2**14)
    kw.setdefault("nbins", 2**10)
    kw.setdefault("clamp_num_samp", False)
    if pkg == "fxtpu":
        pytest.importorskip("jax")
        from fxtpu.config import CorrelatorConfig
        from fxtpu.correlator import Correlator
        from fxtpu.parallel import make_correlator_mesh
        cfg = CorrelatorConfig(**kw)
    else:
        from fxtpu_torch.config import CorrelatorConfig
        from fxtpu_torch.correlator import Correlator
        from fxtpu_torch.parallel import make_correlator_mesh
        cfg = CorrelatorConfig(**kw, device="cpu")
    if mesh is not None:
        devices = (None if pkg == "fxtpu"
                   else [torch.device("cpu")] * (mesh[0] * mesh[1]))
        mesh = make_correlator_mesh(*mesh, devices=devices)
    return Correlator(config=cfg, mesh=mesh)


def _vis(cor, seed=3, delays=None):
    """One step of the correlator's engine on its example inputs, as
    complex numpy."""
    import numpy as np
    iq, d, history = cor.engine.example_inputs(seed=seed)
    if delays is not None:
        d = delays
    vis, _ = cor.engine.step(iq, d, history)
    if hasattr(vis, "re"):
        return np.asarray(vis.re) + 1j * np.asarray(vis.im)
    return vis.numpy() if hasattr(vis, "numpy") else np.asarray(vis)


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_setters_pass_through_to_the_source(pkg):
    """The reference defaults, and each setter stored and passed to the
    source (test_state_machine.py:36-62)."""
    cor = _make(pkg)
    try:
        assert (cor.state, cor.mode) == ("OFF", "SPECTRUM")
        assert (cor.bandwidth, cor.frequency, cor.gain) == (2.4e6, 1.4204e9,
                                                            49.6)
        cor.bandwidth = 2.3e6
        assert cor.bandwidth == cor.source.sample_rate == 2.3e6
        cor.nbins = 2**11
        assert cor.nbins == cor.engine.cfg.nbins == 2**11
        cor.frequency = 1.419e9
        assert cor.frequency == cor.source.center_freq == 1.419e9
        cor.gain = 29.7
        assert cor.gain == cor.source.gain == 29.7
        for seq in (("STARTUP", "RUN", "CALIBRATE", "RUN", "SHUTDOWN", "OFF"),
                    ("STARTUP", "SHUTDOWN", "OFF")):
            for state in seq:
                cor.state = state
                assert cor.state == state
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_mutations_rebuild_the_engine(pkg):
    """nbins changes the output's shape and the history's; mode switches
    the reduction; frequency the rotation; a no-op keeps the engine
    (test_state_machine.py:208-262)."""
    import numpy as np
    cor = _make(pkg, mode="SPECTRUM")
    try:
        cor.nbins = 2**9
        assert cor.engine.cfg.nbins == 2**9
        assert _vis(cor).shape == (1, 2**9)
        assert tuple(cor.history.shape) == (2, cor.config.ntaps - 1, 2**9)
        eng = cor.engine
        cor.nbins = cor.nbins
        assert cor.engine is eng
        d = np.asarray([0.0, 1e-7], np.float32)
        if pkg == "fxtpu_torch":
            d = torch.from_numpy(d)
        v1 = _vis(cor, delays=d)
        cor.frequency = 1.2e9
        assert not np.allclose(v1, _vis(cor, delays=d))
        cor.mode = "CONTINUUM"
        assert _vis(cor).shape == (1,)
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_num_samp_mutation_resizes_rings_and_clamps(pkg):
    """num_samp resizes the rings before streaming, raises once a feeder
    runs, rejects a block shorter than one PFB window, and is clamped to
    [2^8, 2^18] where the config clamps (the reference's bounds)."""
    cor = _make(pkg)
    try:
        cor.num_samp = 2**13
        assert cor.config.num_samp == 2**13
        assert cor.bufs[0].block_shape == (2**13,)
        iq, _, _ = cor.engine.example_inputs(seed=3)
        width = iq.shape[-1] if hasattr(iq, "shape") else iq.re.shape[-1]
        assert width == 2**13
        cor.feeder = object()            # as if streaming had started
        with pytest.raises(RuntimeError):
            cor.num_samp = 2**12
        cor.feeder = None
        with pytest.raises(ValueError):
            cor.num_samp = 2**10         # below one 4-tap window of 1024
    finally:
        cor.close()
    cor = _make(pkg, clamp_num_samp=True, nbins=256)
    try:
        cor.num_samp = 2**20
        assert cor.num_samp == cor.config.num_samp == 2**18
        assert cor.bufs[0].block_shape == (2**18,)
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_mutation_under_a_mesh_keeps_the_mesh(pkg):
    """Under a (2, 2) CPU mesh a rebuilt engine keeps the mesh, the sample
    span is recomputed (one process: none, every sample is its own), and
    the rebuilt step runs sharded at the new shape; the two packages'
    visibilities agree after the same mutations."""
    import numpy as np
    cor = _make(pkg, mesh=(2, 2), nbins=256)
    other = _make("fxtpu_torch" if pkg == "fxtpu" else "fxtpu", mesh=(2, 2),
                  nbins=256)
    try:
        mesh = cor.engine.mesh
        for c in (cor, other):
            c.num_samp = 2**13
            c.nbins = 512
        assert cor.engine.mesh is mesh
        assert cor.sample_span is None
        assert cor.bufs[0].block_shape == (2**13,)
        vis, want = _vis(cor), _vis(other)
        assert vis.shape == (1, 512)
        np.testing.assert_allclose(vis, want, rtol=5e-4, atol=5e-7)
    finally:
        cor.close()
        other.close()


# --------------------------------------------------------------------------
# The rest of tests/test_state_machine.py, each case for both packages:
# the defaults, the transitions and the refused ones, the off-nominal
# inits, supervision, the reference's keyword constructor and the
# keyboard thread on a real tty
# --------------------------------------------------------------------------

def _names(pkg):
    """(CorrelatorConfig with the package's CPU placement, Correlator,
    StateTransitionError) of ``pkg``."""
    if pkg == "fxtpu":
        pytest.importorskip("jax")
        from fxtpu.config import CorrelatorConfig
        from fxtpu.correlator import Correlator, StateTransitionError
        return CorrelatorConfig, Correlator, StateTransitionError
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.correlator import Correlator, StateTransitionError

    def config(**kw):
        return CorrelatorConfig(**kw, device="cpu")
    return config, Correlator, StateTransitionError


PKGS = ["fxtpu", "fxtpu_torch"]


def _walk(cor, sequence):
    for state in sequence:
        cor.state = state
        assert cor.state == state


@pytest.mark.parametrize("pkg", PKGS)
def test_correlator_init(pkg):
    cor = _make(pkg)
    try:
        assert cor.state == "OFF" and cor.mode == "SPECTRUM"
        assert (cor.bandwidth, cor.frequency, cor.gain) == (2.4e6, 1.4204e9,
                                                            49.6)
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_nominal_state_transitions(pkg):
    cor = _make(pkg)
    try:
        _walk(cor, ("STARTUP", "RUN", "CALIBRATE", "RUN", "SHUTDOWN", "OFF"))
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_early_aborts(pkg):
    cor = _make(pkg)
    try:
        for seq in (("STARTUP", "SHUTDOWN", "OFF"),
                    ("STARTUP", "RUN", "SHUTDOWN", "OFF"),
                    ("STARTUP", "RUN", "CALIBRATE", "SHUTDOWN", "OFF"),
                    ("STARTUP", "RUN", "CALIBRATE", "RUN", "SHUTDOWN",
                     "OFF")):
            _walk(cor, seq)
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("path,bad", [
    ((), "OFF"), ((), "RUN"), (("STARTUP",), "STARTUP"),
    (("STARTUP", "RUN"), "RUN"), (("STARTUP", "RUN"), "STARTUP"),
    (("STARTUP", "RUN", "CALIBRATE"), "CALIBRATE"),
    (("STARTUP", "RUN", "CALIBRATE"), "STARTUP")],
    ids=["OFF-OFF", "OFF-RUN", "STARTUP-STARTUP", "RUN-RUN", "RUN-STARTUP",
         "CALIBRATE-CALIBRATE", "CALIBRATE-STARTUP"])
def test_bad_transitions(pkg, path, bad):
    """The four refused-transition cases of fxtpu's tests (from OFF,
    STARTUP, RUN and CALIBRATE), each edge on a fresh Correlator."""
    _, _, error = _names(pkg)
    cor = _make(pkg)
    try:
        _walk(cor, path)
        with pytest.raises(error):
            cor.state = bad
        assert cor.state == (path[-1] if path else "OFF")
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_unknown_state_raises(pkg):
    cor = _make(pkg)
    try:
        with pytest.raises(ValueError):
            cor.state = "WARP"
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_nested_exception_alias(pkg):
    _, correlator, error = _names(pkg)
    assert correlator.StateTransitionError is error


@pytest.mark.parametrize("pkg", PKGS)
def test_bad_run_time_init(pkg):
    with pytest.raises(ValueError):
        _make(pkg, run_time=0)


@pytest.mark.parametrize("pkg", PKGS)
def test_bad_bandwidth_init(pkg):
    _make(pkg, bandwidth=3.0e6).close()   # constructs; sources may warn


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode,want", [("FOO", None),
                                       ("CONTINUUM", "CONTINUUM"),
                                       ("continuum", "CONTINUUM")],
                         ids=["bad", "alt", "lowercase"])
def test_mode_init(pkg, mode, want):
    """The bad mode raises; the alternative mode and a lowercase one
    construct in OFF with the mode upper-cased."""
    if want is None:
        with pytest.raises(ValueError):
            _make(pkg, mode=mode)
        return
    cor = _make(pkg, mode=mode)
    assert (cor.state, cor.mode) == ("OFF", want)
    cor.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_pfb_constraint_enforced(pkg):
    config, _, _ = _names(pkg)
    with pytest.raises(ValueError):
        config(num_samp=2**10, nbins=2**10, ntaps=4, clamp_num_samp=False)


@pytest.mark.parametrize("pkg", PKGS)
def test_child_exception_forces_shutdown(pkg):
    cor = _make(pkg)
    try:
        cor.exc_queue.put("boom traceback")
        assert cor._child_threw_exception()
        assert not cor._child_threw_exception()
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_num_samp_mutation_after_start_raises(pkg):
    cor = _make(pkg)
    try:
        cor.feeder = object()   # as if streaming had started
        with pytest.raises(RuntimeError):
            cor.num_samp = 2**13
        cor.feeder = None
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_invalid_mutation_raises(pkg):
    cor = _make(pkg, ntaps=4)
    try:
        with pytest.raises(ValueError):
            cor.num_samp = 2**10   # below one 4-tap window of 1024 bins
        assert cor.config.num_samp == 2**14
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_reference_kwarg_constructor(pkg):
    _, correlator, _ = _names(pkg)
    kw = dict(run_time=1, bandwidth=2.4e6, frequency=1.4204e9,
              num_samp=2**14, nbins=2**10, gain=49.6, mode="SPECTRUM",
              loglevel="WARNING", clamp_num_samp=False)
    if pkg == "fxtpu_torch":
        kw["device"] = "cpu"
    cor = correlator(**kw)
    assert cor.mode == "SPECTRUM" and cor.num_samp == 2**14
    cor.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_complex128_dtype_rejected(pkg):
    """complex128 raises in both packages.  The messages differ by design
    (ROADMAP, known differences of route): fxtpu's names the TPU planes'
    measured 3.1e-5 bound, the port's that it is built for complex64."""
    config, _, _ = _names(pkg)
    with pytest.raises(ValueError, match=("3.1e-5" if pkg == "fxtpu"
                                          else "complex64 samples only")):
        config(dtype="complex128")


class _Deadline:
    """SIGALRM after ``seconds`` in the main thread (a pty read that
    never returns fails the case instead of holding its worker)."""

    def __init__(self, seconds):
        self.seconds = seconds

    def __enter__(self):
        import signal
        import threading

        def fire(*_):
            raise TimeoutError(f"no answer in {self.seconds} s")
        self.armed = threading.current_thread() is threading.main_thread()
        if self.armed:
            self.old = signal.signal(signal.SIGALRM, fire)
            signal.setitimer(signal.ITIMER_REAL, self.seconds)
        return self

    def __exit__(self, *exc):
        import signal
        if self.armed:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, self.old)


@pytest.mark.parametrize("pkg", PKGS)
def test_kbd_thread_reads_stdin_through_a_real_tty(pkg, monkeypatch):
    """``Correlator._get_kbd`` on a pty: the typed character (with its
    return, the pty is in canonical mode) arrives on the queue, and the
    thread ends once the state leaves the listening set.  The whole case
    has a 30 s deadline of its own."""
    import os
    import pty
    import queue
    import sys
    import threading

    _, correlator, _ = _names(pkg)
    master, slave = pty.openpty()
    fake_stdin = os.fdopen(slave, "r")
    assert fake_stdin.isatty()
    monkeypatch.setattr(sys, "stdin", fake_stdin)

    class _Shell:                      # the attribute _get_kbd reads
        state = "RUN"

    shell = _Shell()
    kq = queue.Queue(4)
    th = threading.Thread(target=correlator._get_kbd, args=(shell, kq),
                          daemon=True)
    try:
        with _Deadline(30):
            th.start()
            os.write(master, b"c\n")
            assert kq.get(timeout=10) == "c"
            shell.state = "SHUTDOWN"
            os.write(master, b"x\n")       # unblock any read in flight
            th.join(timeout=10)
            alive = th.is_alive()
    finally:
        os.close(master)
    assert not alive
    leftovers = []
    while not kq.empty():
        leftovers.append(kq.get_nowait())
    assert set(leftovers) <= {"\n", "x"}
