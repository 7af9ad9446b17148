"""The port's crossover bench (kernels/bench_kernels.py), its looped timer
(utils/mfu.py: make_looped, time_looped) and the raster loaders on the
CPU, where the kernels run as their plain twins and every time is the
host's.  The card's side (the timer's CUDA graphs, the kernels) is in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from torch_parity import torch_one_thread  # noqa: F401
from vinsat_tpu_torch.kernels import bench_kernels, tridiag_pcr
from vinsat_tpu_torch.tools import raster
from vinsat_tpu_torch.utils import mfu

JAX_VARIANTS = {"thomas", "chunked_spike", "bcr_base1", "bcr_base16",
                "chunked_bcrred_m8", "chunked_bcrred_m16"}


def _step(x, w):
    return torch.tanh(x @ w)


def _chain(x, y):
    return x + 1e-3 * y


def test_make_looped_is_the_chained_calls():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 5, generator=gen, dtype=torch.float64)
    w = torch.randn(5, 5, generator=gen, dtype=torch.float64)
    want = x
    for _ in range(7):
        want = _chain(want, _step(want, w))
    got = mfu.make_looped(_step, _chain, 7)(x, w)
    assert torch.equal(got, want)


def test_time_looped_on_the_cpu():
    x = torch.ones(64, 64, dtype=torch.float64)
    t = mfu.time_looped(_step, _chain, x, x / 64, R=4, repeats=2)
    assert np.isfinite(t) and t > 0
    lp = mfu.looped(_step, _chain, x, x / 64, R=4, repeats=2)
    assert lp.R == 4 and lp.nodes is None
    with pytest.raises(ValueError):
        mfu.looped(_step, _chain, x, x, R=1)


def test_bench_tridiag_rows_on_the_cpu():
    before = tridiag_pcr.block_tridiag_solve_pcr.launches
    rows = bench_kernels.bench_tridiag(sizes=(64,), R=2, repeats=1,
                                       dtype=torch.float64, device="cpu")
    assert {r["variant"] for r in rows} == JAX_VARIANTS | {"pcr_plain"}
    for r in rows:
        assert r["N"] == 64 and r["rel_err_vs_thomas"] < 1e-9, r
        # host times under cpu_ names: no device metric from the CPU
        assert "device_ms" not in r and r["cpu_device_ms"] > 0, r
    assert tridiag_pcr.block_tridiag_solve_pcr.launches == before


def test_bench_tridiag_batched():
    rows = bench_kernels.bench_tridiag(
        sizes=(48,), R=2, repeats=1, dtype=torch.float64, device="cpu",
        batch=3, only=("thomas", "bcr_base16", "pcr_plain"))
    assert [r["variant"] for r in rows] == ["thomas", "bcr_base16",
                                            "pcr_plain"]
    assert all(r["B"] == 3 and r["rel_err_vs_thomas"] < 1e-9 for r in rows)


def test_bench_assemble_and_visible_count_rows():
    rows = bench_kernels.bench_assemble(sizes=((16, 4),), R=2, repeats=1,
                                        dtype=torch.float64, device="cpu")
    assert len(rows) == 1 and rows[0]["max_rel_err"] <= 1e-12
    assert rows[0]["cpu_cuda_ms"] > 0 and rows[0]["cpu_library_ms"] > 0
    rows = bench_kernels.bench_visible_count(sizes=((32, 300),), R=2,
                                             repeats=1, device="cpu")
    assert len(rows) == 1 and rows[0]["counts_equal"]
    assert rows[0]["library_ms"] is None


def test_bench_main_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in ([], ["tridiag", "--dtype", "float64"],
                 ["tridiag", "--sizes", "768", "--batch", "8", "--only",
                  "thomas,cuda_pcr"], ["assemble", "--sizes", "112x8"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench_kernels.main(argv)


def test_mfu_parses_jax_flags():
    args = mfu.parser().parse_args(
        ["--sizes", "64,256", "--loop-r", "16", "--batched-lambda", "9",
         "--stages", "solve,iteration", "--tridiag-variant", "bcr16",
         "--dtype", "float64", "--repeats", "3"])
    assert (args.loop_r, args.batched_lambda, args.stages,
            args.tridiag_variant) == (16, 9, "solve,iteration", "bcr16")
    defaults = mfu.parser().parse_args([])
    assert (defaults.loop_r, defaults.batched_lambda, defaults.stages,
            defaults.tridiag_variant) == (64, 0, None, "auto")
    # the CPU gives no device times: measuring there raises
    with pytest.raises(RuntimeError):
        mfu.main(["--sizes", "16", "--device", "cpu"])


def test_raster_loaders(tmp_path):
    img = np.random.default_rng(0).integers(0, 255, (6, 8, 3), np.uint8)
    np.save(tmp_path / "img.npy", img)
    srv = raster.RasterImageServer()
    t = raster.Affine(0.01, 0.0, 10.0, 0.0, -0.01, 20.0)
    srv.load_npy("r", str(tmp_path / "img.npy"), t)
    got, _ = srv.get_window("r", 10.0, 19.94, 10.08, 20.0)
    np.testing.assert_array_equal(got, img)
    try:
        import rasterio  # noqa: F401
    except ImportError:
        assert srv.load_rasterio("g", str(tmp_path / "none.tif")) is False
        assert srv.regions() == ["r"]
    else:
        pytest.skip("rasterio is installed")
