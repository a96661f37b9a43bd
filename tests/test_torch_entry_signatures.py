"""The ctypes signatures of the port's C entry points against their C
declarations, on the CPU.

Every ``extern "C"`` function in ``fxtpu_torch/csrc/*.cu`` is parsed for
its parameter kinds (``const void*`` / ``void*`` / a struct pointer ->
pointer, ``int`` -> int, ``long long`` -> longlong, ``double`` -> double)
and held to what ``cuda_build.declare`` sets on a stub library: ctypes
passes an argument list it was given as it is, so a list one argument
short or with an int where the C side reads a pointer is cut or
misread without an error.  The step entry's argument struct
(``FxtStepArgs``, ``csrc/fx_step.cu``) is held field by field to its
mirror ``cuda_build.StepArgs``, and ``fx_epilogue.step_args`` to the
plan it fills it from."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch import cuda_build  # noqa: E402
from fxtpu_torch.ops import fx_epilogue as fe  # noqa: E402
from fxtpu_torch.ops import fx_fused as ff  # noqa: E402
from fxtpu_torch.ops.dc_posthoc import dc_constants  # noqa: E402
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs, pack_delays  # noqa: E402

CSRC = Path(cuda_build.__file__).resolve().parent / "csrc"


def _kind(decl: str) -> str:
    """A C parameter or field declaration -> its kind."""
    decl = re.sub(r"\b(const|volatile)\b", "", decl)
    if "*" in decl:
        return "pointer"
    words = decl.split()[:-1]       # drop the name
    kinds = {("int",): "int", ("long", "long"): "longlong",
             ("double",): "double"}
    if tuple(words) not in kinds:
        raise ValueError(f"unknown C type in {decl!r}")
    return kinds[tuple(words)]


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", re.sub(r"/\*.*?\*/", "", src, flags=re.S))


def c_entries() -> dict:
    """``{name: (return kind, [parameter kinds])}`` of every ``extern "C"``
    function defined in the sources."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = _strip_comments(src.read_text())
        for m in re.finditer(r'extern\s+"C"\s+([^(]*?)\b(fxt_\w+)\s*\(([^)]*)\)',
                             text):
            ret, name, params = m.groups()
            params = params.strip()
            kinds = ([] if params in ("", "void") else
                     [_kind(p) for p in params.split(",")])
            ret_kind = "pointer" if "*" in ret else _kind(ret + " r")
            if name in out and out[name] != (ret_kind, kinds):
                raise ValueError(f"{name} is defined twice, differently")
            out[name] = (ret_kind, kinds)
    return out


def c_struct(name: str, path: Path) -> list:
    """``[(field, kind)]`` of ``struct name { ... };`` in ``path``."""
    text = _strip_comments(path.read_text())
    m = re.search(r"struct\s+" + name + r"\s*\{(.*?)\};", text, flags=re.S)
    fields = []
    for decl in m.group(1).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        head, *rest = [d.strip() for d in decl.split(",")]
        kind = _kind(head)
        fields.append((head.split()[-1].lstrip("*"), kind))
        fields += [(r.lstrip("*"), kind) for r in rest]
    return fields


def _ctypes_kind(t) -> str:
    if t in (ctypes.c_void_p, ctypes.c_char_p) or (
            isinstance(t, type) and issubclass(t, ctypes._Pointer)):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_longlong: "longlong",
            ctypes.c_double: "double"}[t]


class _StubFn:
    restype = None
    argtypes = None


class _StubLib:
    """What ``cuda_build.declare`` sets, recorded by entry name."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if not name.startswith("fxt_"):
            raise AttributeError(name)
        return self.fns.setdefault(name, _StubFn())


ENTRIES = c_entries()


def test_every_entry_is_declared():
    lib = _StubLib()
    cuda_build.declare(lib)
    assert set(lib.fns) == set(ENTRIES)
    assert {"fxt_fx_step", "fxt_fx_step_i8", "fxt_fx_finish"} <= set(ENTRIES)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_declared_signature_matches_c(name):
    lib = _StubLib()
    cuda_build.declare(lib)
    fn = lib.fns[name]
    ret, params = ENTRIES[name]
    assert [_ctypes_kind(t) for t in fn.argtypes] == params, name
    assert _ctypes_kind(fn.restype) == ret, name


def test_step_struct_matches_its_mirror():
    want = c_struct("FxtStepArgs", CSRC / "fx_step.cu")
    got = [(n, _ctypes_kind(t)) for n, t in cuda_build.StepArgs._fields_]
    assert got == want
    lib = _StubLib()
    cuda_build.declare(lib)
    for entry in ("fxt_fx_step", "fxt_fx_step_i8"):
        assert lib.fns[entry].argtypes[0]._type_ is cuda_build.StepArgs


def _step_case(nch, ingest, k=2, nbins=256, s_rows=32, ntaps=4, seed=3):
    rng = np.random.default_rng(seed)
    w2d = pfb_window(ntaps, nbins, "hann").reshape(ntaps, nbins)
    w = torch.as_tensor(w2d.astype(np.float32))
    pairs_np = baseline_pairs(nch, True)
    pairs = ff.pairs_tensor(pairs_np, nch, "cpu")
    consts = dc_constants(w2d, nbins, s_rows, "cpu")
    tables = fe.FinishTables(pairs_np, nbins, 2.4e6, 1.4204e9, "cpu")
    delays = torch.as_tensor(pack_delays(
        rng.normal(size=(k, nch)) * 1e-6, 1.4204e9))
    if ingest == "int8":
        x = torch.as_tensor(rng.integers(-100, 100, size=(
            nch, k, s_rows, nbins, 2)).astype(np.int8))
        hist = {"tail": torch.zeros((nch, ntaps - 1, nbins, 2),
                                    dtype=torch.int8),
                "mu_prev": torch.zeros(nch, dtype=torch.complex64)}
        step = 1.0 / 32
    else:
        x = torch.as_tensor((rng.normal(size=(nch, k, s_rows, nbins, 2))
                             @ np.array([1.0, 1j])).astype(np.complex64))
        hist = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64)
        step = None
    return fe.check_step(x, hist, w, pairs, consts, delays, tables, 2.4e6,
                         True, step)


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("nch,nbins,s_rows", [(3, 256, 32), (2, 4096, 16),
                                              (8, 4096, 32), (65, 256, 16)])
def test_step_args_carry_the_plan(nch, nbins, s_rows, ingest):
    """``step_args`` puts each of the plan's tensors and numbers in the
    field the C entry reads it from: the route, its groups, the X
    kernel's plan on the wide route (at 65 channels the tiled instance's,
    with its row map), the carried mean for 8-bit samples."""
    plan = _step_case(nch, ingest, nbins=nbins, s_rows=s_rows)
    bufs = fe.step_buffers(plan)
    args = fe.step_args(plan, bufs)
    # 8 spectra of 4096 bins do not fit in a CTA; past 64 channels the
    # shared route is not taken
    wide = nch >= 8
    assert args.rowmap == (plan.rowmap.data_ptr() if nch >= 65 else None)
    assert (plan.rowmap is not None) == (wide and plan.xplan.tiled)
    assert plan.route == ("global" if wide else "shared")
    for field in ("sums", "scratch", "parts", "mu", "new_hist", "vis"):
        assert getattr(args, field) == bufs[field].data_ptr(), field
    assert args.x == plan.x.data_ptr() and args.hist == plan.hist.data_ptr()
    assert args.da == plan.consts[1].data_ptr()
    assert args.delays == plan.delays.data_ptr() and args.packed == 1
    assert args.freqs == plan.freqs.data_ptr()
    assert (args.mu_prev is None) == (ingest == "complex64")
    assert args.step == (1.0 / 32 if ingest == "int8" else 1.0)
    assert (args.nch, args.K, args.S, args.nbins, args.ntaps, args.nbl) == (
        nch, 2, s_rows, nbins, 4, nch * (nch + 1) // 2)
    assert (args.n_groups, args.frames_per_group) == (plan.n_groups, plan.per)
    assert args.wide == int(wide) and args.continuum == 1
    plan_ints = (args.tile, args.slots, args.rows, args.frames, args.stages,
                 args.threads)
    if wide:
        assert plan_ints == plan.xplan.args()
        assert bufs["scratch"].shape == (2, nch, s_rows, nbins)
    else:
        assert plan_ints == (0,) * 6 and plan.xplan is None
        assert bufs["scratch"].shape == (2, plan.n_groups,
                                         plan.nbl + 2 * nch, nbins)
    assert bufs["vis"].shape == (2, plan.nbl)
