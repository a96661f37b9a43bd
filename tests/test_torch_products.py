"""The port's CSV products against ``fxtpu``'s: each case of
``tests/test_products.py`` writes the same visibilities through both
packages' writers, and the files are the same byte for byte (one case
hands the port's writer a torch tensor); the port's reader then holds
the reference's recipe, its headers and its round trip.  The port's
writer thread is also held to waking on a row's put and to its stop."""

import statistics
import threading
import time
from queue import Empty, Queue

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference; absent on the card's machine

from fxtpu import products as jproducts  # noqa: E402
from fxtpu.config import CorrelatorConfig as JConfig  # noqa: E402
from fxtpu_torch import products  # noqa: E402
from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.runtime.metrics import Metrics  # noqa: E402

#: The writer threads' product: a CONTINUUM row a block, one value each.
CONTINUUM = dict(mode="CONTINUUM", num_samp=2**14, nbins=2**10,
                 clamp_num_samp=False)


def _write(tmp_path, rows, **cfg):
    """Write metadata and ``rows`` through both packages' writers; assert
    the files are byte-identical and return the port's path."""
    paths = {}
    for tag, mod, config in (("fxtpu", jproducts, JConfig(**cfg)),
                             ("port", products,
                              CorrelatorConfig(**cfg, device="cpu"))):
        path = str(tmp_path / f"{tag}.csv")
        mod.write_metadata(path, config)
        with open(path, "a") as fh:
            for r in rows:
                if tag == "port" and isinstance(r, np.ndarray):
                    r = torch.from_numpy(r)   # the engine's tensors
                mod.append_visibility(fh, r)
        paths[tag] = path
    with open(paths["fxtpu"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    return paths["port"]


def test_spectrum_header_and_rows(tmp_path):
    vis = (np.arange(2**10) + 1j * np.arange(2**10)).astype(np.complex128)
    path = _write(tmp_path, [vis, vis * 2], mode="SPECTRUM", num_samp=2**14,
                  nbins=2**10, clamp_num_samp=False)
    with open(path) as fh:
        header = fh.readline().strip()
        freq_row = fh.readline().strip()
    assert header.startswith("run_time:1.0,bandwidth:2400000.0,"
                             "frequency:1420400000.0,num_samp:16384,"
                             "resolution:1024,gain:49.6,mode:SPECTRUM")
    expected = np.fft.fftshift(np.fft.fftfreq(2**10, d=1 / 2.4e6)) + 1.4204e9
    got = np.array([float(v) for v in freq_row.split(",")])
    np.testing.assert_allclose(got, expected, rtol=1e-10)
    out = np.loadtxt(path, dtype=np.complex128, delimiter=",", skiprows=2)
    assert out.shape == (2, 2**10)
    np.testing.assert_allclose(out[1], vis * 2)


def test_continuum_header_single_skiprow(tmp_path):
    path = _write(tmp_path, [np.complex128(k + 1j) for k in range(3)],
                  mode="CONTINUUM", num_samp=2**14, nbins=2**10,
                  clamp_num_samp=False)
    out = np.loadtxt(path, dtype=np.complex128, delimiter=",", skiprows=1)
    assert out.shape == (3,)
    for mode, n in (("continuum", 1), ("SPECTRUM", 2), ("test", 1)):
        assert products.skiprows_for_mode(mode) == n
        assert jproducts.skiprows_for_mode(mode) == n


def test_test_mode_header_carries_sweep_step(tmp_path):
    path = _write(tmp_path, [], mode="TEST", num_samp=2**14, nbins=2**10,
                  clamp_num_samp=False)
    md = products.parse_metadata(path)
    assert float(md["sweep_step"]) == pytest.approx((1 / 1.4204e9) / 2)
    assert md == jproducts.parse_metadata(path)


def test_nbl_matrix_rows(tmp_path):
    """A [6, 16] matrix (4 channels, 6 baselines) as a torch tensor in the
    port's writer: the same bytes as fxtpu's from the numpy array."""
    rng = np.random.default_rng(5)
    vis = (rng.normal(size=(6, 16)) + 1j * rng.normal(size=(6, 16))
           ).astype(np.complex64)
    path = _write(tmp_path, [vis], mode="SPECTRUM", num_samp=2**14, nbins=16,
                  nchan=4, clamp_num_samp=False)
    assert products.parse_metadata(path)["nchan"] == "4"
    out = np.loadtxt(path, dtype=np.complex128, delimiter=",", skiprows=2)
    assert out.shape == (6, 16)
    np.testing.assert_array_equal(out, vis.astype(np.complex128))


def test_load_products_roundtrip(tmp_path):
    path = _write(tmp_path, [np.complex128(3 + 4j)], mode="CONTINUUM",
                  num_samp=2**14, nbins=2**10, clamp_num_samp=False)
    md, data = products.load_products(path)
    jmd, jdata = jproducts.load_products(path)
    assert md == jmd and md["mode"] == "CONTINUUM"
    assert data == jdata == 3 + 4j


def _value(k):
    return np.complex128(k + 0.5j)


def _port_item(k):
    """Row ``k`` as the Correlator queues it: ``(seq, vis)``, a tensor."""
    return k, torch.tensor(_value(k), dtype=torch.complex64)


def _start(mod, path, **kw):
    """Write a CONTINUUM header at ``path`` and start ``mod``'s writer,
    active until the returned event is cleared, on a new queue."""
    config = (JConfig(**CONTINUUM) if mod is jproducts
              else CorrelatorConfig(**CONTINUUM, device="cpu"))
    mod.write_metadata(path, config)
    q = Queue()
    active = threading.Event()
    active.set()
    w = mod.VisibilityWriter(path, q, active_fn=active.is_set, **kw).start()
    return w, q, active


def _stop(w, active, within=1.0):
    """Clear ``active`` and assert the writer's thread ends ``within``
    seconds."""
    active.clear()
    w.join(within)
    assert not w._thread.is_alive()


def _rows(path):
    """The seq (the real part) of each data row of a CONTINUUM file."""
    with open(path) as fh:
        return [int(complex(line.strip()).real) for line in fh.readlines()[1:]]


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_visibility_writer_thread(tmp_path):
    """Both packages' writer threads write the same five rows, the port's
    from ``(seq, vis)`` items of torch tensors."""
    def run(mod, path, item):
        w, q, active = _start(mod, path)
        for k in range(5):
            q.put(item(k))
        time.sleep(0.3)
        _stop(w, active, 2.0)
        return w.rows_written
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    assert run(jproducts, a, _value) == 5
    assert run(products, b, _port_item) == 5
    _same_bytes(a, b)
    _, data = products.load_products(b)
    assert data.shape == (5,)


def test_writer_wakes_on_the_put(tmp_path):
    """An active port writer writes a row soon after its put: of 10 rows
    put 50 ms apart, the median from the put to the row's count in
    ``rows_written`` is under 20 ms (a 0.1 s poll's would be about 50).
    ``products.wakes`` counts the blocking gets that returned a row (one
    a row while the writer keeps up; fewer where a slow host lets rows
    queue up), and the file is ``fxtpu``'s writer's byte for byte."""
    metrics = Metrics()
    port = str(tmp_path / "port.csv")
    w, q, active = _start(products, port, metrics=metrics)
    waits = []
    for k in range(10):
        t0 = time.perf_counter()
        q.put(_port_item(k))
        while w.rows_written <= k and time.perf_counter() - t0 < 1.0:
            time.sleep(2e-4)
        waits.append(time.perf_counter() - t0)
        time.sleep(max(0.05 - (time.perf_counter() - t0), 0.0))
    _stop(w, active)
    assert w.rows_written == metrics.get("products.rows_written") == 10
    assert statistics.median(waits) < 0.02, waits
    assert 1 <= metrics.get("products.wakes") <= 10
    ref = str(tmp_path / "fxtpu.csv")
    w, q, active = _start(jproducts, ref)
    for k in range(10):
        q.put(_value(k))
    _stop(w, active)
    _same_bytes(ref, port)


@pytest.mark.parametrize("emptied", [False, True],
                         ids=["rows_put_before_stop", "queue_emptied"])
def test_writer_stops_within_a_second(tmp_path, emptied):
    """Rows put just before ``active`` is cleared are all written, and the
    writer ends within 1 s.  ``emptied``: as the benchmark's stop does, a
    second thread empties the queue with ``get_nowait`` while the writer
    blocks on it; the writer still ends within 1 s of the clear, and each
    row is either on disk once, in order, or taken by the other thread."""
    path = str(tmp_path / "port.csv")
    w, q, active = _start(products, path, metrics=Metrics())
    taken, done = [], threading.Event()

    def take():
        while not done.is_set():
            try:
                taken.append(q.get_nowait()[0])
            except Empty:
                time.sleep(1e-4)
    thief = threading.Thread(target=take, daemon=True)
    if emptied:
        thief.start()
    n = 40
    for k in range(n):
        q.put(_port_item(k))
        if emptied:
            time.sleep(1e-3)
    if emptied:
        time.sleep(0.15)   # the writer blocks on the emptied queue
    _stop(w, active)
    done.set()
    if emptied:
        thief.join(1.0)
        assert not thief.is_alive()
    on_disk = _rows(path)
    assert len(on_disk) == w.rows_written
    assert on_disk == sorted(set(on_disk))
    assert sorted(on_disk + taken) == list(range(n))
    if not emptied:
        assert on_disk == list(range(n))


def test_reads_reference_written_file(tmp_path):
    """A CSV written as the reference writes it (no sweep_step, its header
    order, effex.py:671-684) loads through both readers alike."""
    path = str(tmp_path / "ref.csv")
    nbins, bw, fc = 64, 2.4e6, 1.4204e9
    with open(path, "w") as fh:
        fh.write("run_time:60,bandwidth:2400000.0,frequency:1420400000.0,"
                 "num_samp:262144,resolution:64,gain:49.6,mode:SPECTRUM\n")
        freqs = np.fft.fftshift(np.fft.fftfreq(nbins, d=1 / bw)) + fc
        np.savetxt(fh, [freqs], delimiter=",")
        np.savetxt(fh, [(np.arange(nbins) + 1j).astype(np.complex128)],
                   delimiter=",")
    md, data = products.load_products(path)
    jmd, jdata = jproducts.load_products(path)
    assert md == jmd and md["mode"] == "SPECTRUM" and md["gain"] == "49.6"
    assert data.shape == (nbins,)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_allclose(data.imag, 1.0)


def test_visualize_single_spectrum_row():
    """A one-row SPECTRUM product (1-D after np.loadtxt) is promoted to a
    [1, nbins] waterfall by the port's visualize, as by fxtpu's."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from fxtpu_torch.post_process import visualize
    rng = np.random.default_rng(1)
    vis = rng.normal(size=64) + 1j * rng.normal(size=64)
    vis2 = rng.normal(size=(5, 64)) + 1j * rng.normal(size=(5, 64))
    for v in (vis, vis2):
        fig = visualize(v, rate=2.4e6, fc=1.42e9, nfft=64, mode="SPECTRUM",
                        show=False)
        assert fig is not None
        plt.close(fig)
