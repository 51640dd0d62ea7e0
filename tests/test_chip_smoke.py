"""chip_smoke.py: its device gate, output contract and phases at small sizes.

The phases run here on the CPU at toy sizes (the oracles and control flow
are the same as on the card). Tests marked ``gpu`` run the same phases on
a GPU and skip elsewhere; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import importlib
import json
import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402

# toy sizes for every phase (the defaults are the card's sizes)
SMALL = {
    "fft": dict(c2c_n=64, rfft_sizes=(6, 8), batched_sizes=(6, 10),
                batch_bytes=1 << 14, reps=1),
    "pconv": dict(ir_len=1 << 10, parts=64, host_block=16, seconds=0.05,
                  scan_blocks=40, split_pts=128, split_len=1 << 10, reps=1),
    "tv": dict(size=1 << 10, parts=64, host_block=16, seconds=0.05,
               scan_blocks=40, reps=1),
    "long-ir": dict(pts=64, ir_len=1 << 11, timed_blocks=20, reps=1),
    "serving": dict(batch=4, pts=64, ir_len=1 << 10, nblocks=32, swap=(1,),
                    after=12, reps=1),
    "offline": dict(ir_len=1 << 10, pts=64, seconds=0.1, fir=64,
                    fir_block=64, fir_blocks=20, zl_block=16,
                    zl_seconds=0.05, reps=1),
    "pipeline": dict(pts=128, ir_len=1 << 10, seconds=0.5),
    "f64": dict(n=1 << 10, pts=64, nparts=4, nblocks=16),
    "determinism": dict(ir_len=1 << 10, pts=64, nblocks=40, K=8,
                        chunk_blocks=16),
}
PHASES = dict(C.PHASES)


def _run_phase(name):
    if name == "pipeline":
        from opencl_fft_tpu import runtime
        if not runtime.native_available():
            pytest.skip("native runtime unavailable (no C++ toolchain)")
    rep = C.Report()
    PHASES[name](rep, **SMALL[name])
    assert rep.failed == [], rep.failed
    assert any(r.get("ok") for r in rep.rows)


@pytest.mark.parametrize("name", list(SMALL))
def test_phase_small_on_cpu(name):
    assert set(SMALL) == set(PHASES)
    _run_phase(name)


@pytest.fixture
def gpu():
    """Decided when the test runs, never at import."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {devs[0].platform!r})")
    return devs[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SMALL))
def test_phase_small_on_gpu(gpu, name):
    _run_phase(name)


FOUR_SMALL = dict(batch=8, pts=64, ir_len=1 << 10, long_len=1 << 12,
                  nblocks=8, fft_n=1 << 12, reps=1)


def test_four_phase_small_on_cpu_mesh():
    """The --four phase on four of the virtual CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs four devices")
    rep = C.Report()
    C.phase_four(rep, **FOUR_SMALL)
    assert rep.failed == []
    assert sum(bool(r.get("ok")) for r in rep.rows) == 3


@pytest.mark.gpu
def test_four_gpu_phase_small(gpu):
    if len(jax.devices()) < 4:
        pytest.skip("needs four GPUs")
    rep = C.Report()
    C.phase_four(rep, **FOUR_SMALL)
    assert rep.failed == []


# ---------------------------------------------------------------------------
# device gate and output contract
# ---------------------------------------------------------------------------


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit):
        C.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        C.require_gpu([])


def test_main_refuses_cpu_without_result_line(capsys, monkeypatch, tmp_path):
    # an explicit cache dir: setup_compile_cache then sets nothing in code
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        C.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_last_line_format():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = C.result_line([Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert json.loads(C.result_line([Dev()] * 4))["device"]["count"] == 4
    assert "\n" not in line


@pytest.mark.parametrize("line,expect", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("NVIDIA H100 80GB HBM3, 400.00 W\n", ("NVIDIA H100 80GB HBM3",
                                            "400.00 W")),
    ("Some, Card, 350.00 W", ("Some, Card", "350.00 W")),
])
def test_parse_smi_line(line, expect):
    assert C.parse_smi_line(line) == expect


@pytest.mark.parametrize("line", ["", "no comma here", ", 700 W", "H100,"])
def test_parse_smi_line_rejects_malformed(line):
    with pytest.raises(ValueError):
        C.parse_smi_line(line)


# ---------------------------------------------------------------------------
# compile cache location
# ---------------------------------------------------------------------------


def test_cache_dir_unset_is_checkout_jax_cache():
    from opencl_fft_tpu.utils import compile_cache as CC

    d = CC.cache_dir({})
    assert d == os.path.join(ROOT, ".jax_cache")
    assert ".jax_cache/" in open(os.path.join(ROOT, ".gitignore")).read()


def test_cache_dir_set_is_used_verbatim():
    from opencl_fft_tpu.utils import compile_cache as CC

    assert CC.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"


def test_setup_compile_cache_sets_config_only_when_unset(monkeypatch):
    from opencl_fft_tpu.utils import compile_cache as CC

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere")
    assert CC.setup_compile_cache() == "/somewhere"
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert CC.setup_compile_cache() == CC.DEFAULT_DIR
    assert calls == [("jax_compilation_cache_dir", CC.DEFAULT_DIR)]


# ---------------------------------------------------------------------------
# no kernel of the retired accelerator remains
# ---------------------------------------------------------------------------

RETIRED = "jax.experimental.pallas.tpu"


def test_no_module_imports_pallas_tpu():
    """Walk the package (and the entry scripts): no source names the
    retired Pallas module, and importing every module loads none."""
    import opencl_fft_tpu

    pkg_dir = os.path.dirname(opencl_fft_tpu.__file__)
    files = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "bench.py",
                                             "__graft_entry__.py")]
    for dirpath, _dirs, names in (*os.walk(pkg_dir),
                                  *os.walk(os.path.join(ROOT, "examples"))):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        src = open(path).read()
        for word in (RETIRED.split(".", 2)[2], "pallas import "
                     + RETIRED.rsplit(".", 1)[1], "pl" + RETIRED[-3:]):
            assert word not in src, (path, word)
    for path in files:
        if path.startswith(pkg_dir + os.sep):
            rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
            importlib.import_module(rel.removesuffix(".__init__"))
    assert RETIRED not in sys.modules


def test_auto_fft_routing_follows_measurement():
    """impl='auto' is jnp.fft on every backend (cuFFT beat the matmul
    tree at every size 2^10..2^20 on the H100); the engine's own
    transforms take it too."""
    import jax.numpy as jnp

    from opencl_fft_tpu.ops import fft as F
    from opencl_fft_tpu.ops import pconv as P

    x = (jnp.zeros((3, 4096)), jnp.zeros((3, 4096)))
    assert "fft" in str(jax.make_jaxpr(lambda s: F.fft_split(s, -1))(x))
    cfg = P.PconvConfig(pts=256, nparts=2)
    inv = str(jax.make_jaxpr(lambda a: P._inverse_and_ola(
        cfg, P.pconv_init(cfg), (a, a)))(jnp.zeros(256)))
    assert "fft" in inv
