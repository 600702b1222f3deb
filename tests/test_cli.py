"""CLI tests driven through octproz_tpu.cli.main (the argparse surface)."""

import json

import numpy as np
import pytest

from octproz_tpu.cli import main


@pytest.fixture(scope="module")
def raw_file(tmp_path_factory):
    """Two small buffers of 12-bit fringes with a reflector at depth 20."""
    d = tmp_path_factory.mktemp("cli")
    n, asc, bsc = 128, 8, 4
    k = np.arange(n)
    spec = 1000.0 + 400.0 * np.cos(2 * np.pi * 20 * k / n)
    vol = np.tile(spec, (2, bsc, asc, 1)).astype(np.uint16)
    path = d / "in.raw"
    vol.tofile(path)
    return str(path), n, asc, bsc


def _geom(n, asc, bsc):
    return ["--samples", str(n), "--ascans", str(asc), "--bscans", str(bsc),
            "--buffers-per-volume", "2", "--bit-depth", "12"]


def test_process_writes_outputs(raw_file, tmp_path, capsys):
    path, n, asc, bsc = raw_file
    out = tmp_path / "out.raw"
    png = tmp_path / "b.png"
    rc = main(["process", path, *_geom(n, asc, bsc), "--fpn", "off",
               "--output", str(out), "--bscan-png", str(png)])
    assert rc == 0
    data = np.fromfile(out, np.float32).reshape(2 * bsc, asc, n // 2)
    assert np.isfinite(data).all()
    ascan = data[0, 4]
    assert ascan[18:23].max() > np.median(ascan)  # reflector at depth 20
    assert png.exists()


def test_process_fused_matches_unfused(raw_file, tmp_path):
    """The full fold (--fft-matmul) against the staged FFT chain."""
    path, n, asc, bsc = raw_file
    a, b = tmp_path / "a.raw", tmp_path / "b.raw"
    assert main(["process", path, *_geom(n, asc, bsc), "--fpn", "off",
                 "--output", str(a)]) == 0
    assert main(["process", path, *_geom(n, asc, bsc), "--fpn", "off",
                 "--fft-matmul", "--output", str(b)]) == 0
    np.testing.assert_allclose(np.fromfile(a, np.float32),
                               np.fromfile(b, np.float32), atol=5e-2)


def test_process_precision_flags(raw_file, tmp_path):
    """--matmul-precision / --compute-dtype / --output-dtype reach the
    pipeline: the fidelity ladder stays close to the default output."""
    path, n, asc, bsc = raw_file
    a, b = tmp_path / "pa.raw", tmp_path / "pb.raw"
    assert main(["process", path, *_geom(n, asc, bsc), "--fpn", "off",
                 "--fft-matmul", "--output", str(a)]) == 0
    assert main(["process", path, *_geom(n, asc, bsc), "--fpn", "off",
                 "--fft-matmul", "--matmul-precision", "highest",
                 "--output", str(b)]) == 0
    np.testing.assert_allclose(np.fromfile(a, np.float32),
                               np.fromfile(b, np.float32), atol=5e-2)
    assert main(["process", path, *_geom(n, asc, bsc), "--fpn", "off",
                 "--fft-matmul", "--compute-dtype", "bfloat16",
                 "--output-dtype", "bfloat16", "--output", str(b)]) == 0


def test_replay_reports_json(raw_file, capsys):
    path, n, asc, bsc = raw_file
    rc = main(["replay", path, *_geom(n, asc, bsc), "--fpn", "off",
               "--max-buffers", "4"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["buffers_processed"] == 4
    assert report["ascans_per_s"] > 0


def test_render_command(raw_file, tmp_path):
    vol = np.random.default_rng(0).random((8, 8, 16)).astype(np.float32)
    vol_file = tmp_path / "v.raw"
    vol.tofile(vol_file)
    out = tmp_path / "r.png"
    rc = main(["render", str(vol_file), "--bscans", "8", "--ascans", "8",
               "--depth", "16", "--mode", "xray", "--size", "16",
               "--out", str(out)])
    assert rc == 0 and out.exists()


def test_missing_file_clean_error(capsys):
    rc = main(["process", "/nope/missing.raw", "--samples", "64",
               "--ascans", "8", "--bscans", "2"])
    assert rc == 1
    assert "error: file not found" in capsys.readouterr().err


def test_bad_reshape_clean_error(tmp_path, capsys):
    f = tmp_path / "small.raw"
    np.zeros(16, np.float32).tofile(f)
    rc = main(["render", str(f), "--bscans", "9", "--ascans", "9",
               "--depth", "9", "--out", str(tmp_path / "x.png")])
    assert rc == 1
    assert "error:" in capsys.readouterr().err


def test_info_runs(capsys):
    assert main(["info", "--no-entry-point-plugins"]) == 0
    out = capsys.readouterr().out
    assert "octproz_tpu" in out
    # registry report: built-in systems + (none) extensions visible
    assert "acquisition systems: phytooct" in out
    assert "extensions:" in out


def test_process_with_mesh(tmp_path, capsys):
    """--mesh B,A shards the process command over the virtual device mesh."""
    import numpy as np

    from octproz_tpu.cli import main

    acq_shape = (4, 8, 64)
    raw = np.random.default_rng(0).integers(
        0, 4095, size=acq_shape).astype(np.uint16)
    inp = tmp_path / "in.raw"
    raw.tofile(inp)
    out = tmp_path / "out.raw"
    rc = main(["process", str(inp), "--samples", "64", "--ascans", "8",
               "--bscans", "4", "--no-dispersion", "--mesh", "4,2",
               "--output", str(out)])
    assert rc == 0
    vol = np.fromfile(out, np.float32)
    assert vol.size == 4 * 8 * 32


def test_replay_from_acquisition_system(tmp_path, capsys):
    """'system:phytooct' streams from the registered portable system with
    its device settings read from the [system:phytooct] INI group."""
    ini = tmp_path / "s.ini"
    ini.write_text("[system:phytooct]\n"
                   "samples_per_line = 128\nascans_per_bscan = 16\n"
                   "bscans_per_buffer = 2\nbuffers_per_volume = 3\n"
                   "exposure_us = 0.0\n")
    rc = main(["replay", "system:phytooct", "--settings", str(ini),
               "--metrics-window", "0.5"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["buffers_processed"] == 3


def test_replay_system_cli_flags_override_device_defaults(tmp_path, capsys):
    ini = tmp_path / "s.ini"
    ini.write_text("[system:phytooct]\n"
                   "samples_per_line = 128\nascans_per_bscan = 16\n"
                   "bscans_per_buffer = 2\nbuffers_per_volume = 2\n"
                   "exposure_us = 0.0\n")
    # the device recommends sinusoidal correction; an explicit flag set
    # still wins (here: turn FPN off and cap buffers)
    rc = main(["replay", "system:phytooct", "--settings", str(ini),
               "--fpn", "off", "--max-buffers", "1"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["buffers_processed"] == 1


def test_replay_system_rejects_cli_geometry_flags(tmp_path, capsys):
    """The device owns its geometry: explicit --samples with a system:
    source is an error, not a silent no-op."""
    with pytest.raises(SystemExit, match="geometry"):
        main(["replay", "system:phytooct", "--samples", "2048"])


def test_process_from_acquisition_system(tmp_path, capsys):
    ini = tmp_path / "s.ini"
    ini.write_text("[system:phytooct]\n"
                   "samples_per_line = 128\nascans_per_bscan = 16\n"
                   "bscans_per_buffer = 2\nbuffers_per_volume = 2\n"
                   "exposure_us = 0.0\n")
    out = tmp_path / "out.raw"
    rc = main(["process", "system:phytooct", "--settings", str(ini),
               "--output", str(out)])
    assert rc == 0
    data = np.fromfile(out, np.float32).reshape(4, 16, 64)
    assert np.isfinite(data).all()


def test_preset_base_with_flag_overlay(tmp_path, capsys):
    """--preset seeds geometry + chain; explicit flags overlay it."""
    # small synthetic file matching an overridden geometry
    n, asc, bsc = 128, 8, 4
    vol = np.zeros((bsc, asc, n), np.uint16)
    path = tmp_path / "p.raw"
    vol.tofile(path)
    out = tmp_path / "o.raw"
    rc = main(["process", str(path), "--preset", "benchmark",
               "--samples", str(n), "--ascans", str(asc),
               "--bscans", str(bsc), "--buffers-per-volume", "1",
               "--fpn", "off", "--output", str(out)])
    assert rc == 0
    assert out.stat().st_size == bsc * asc * (n // 2) * 4



@pytest.fixture()
def small_raw_file(tmp_path):
    """One tiny 12-bit file: 4 buffers of 2x8 A-scans x 64 samples."""
    rng = np.random.default_rng(9)
    vol = rng.integers(0, 4095, size=(4, 2, 8, 64)).astype(np.uint16)
    path = tmp_path / "small.raw"
    vol.tofile(path)
    return path


def test_replay_metrics_json_stream(tmp_path, capsys, small_raw_file):
    """--metrics-json streams each throughput window as JSONL and the
    final report carries the window summary (the engine's live-counter
    record, processing.cpp:193-207 analog; ENGINE_r04 methodology)."""
    mpath = tmp_path / "windows.jsonl"
    rc = main(["replay", str(small_raw_file), "--samples", "64",
               "--ascans", "8", "--bscans", "2", "--max-buffers", "12",
               "--wait-us", "20000",  # paced; the tail outlives the compile
               "--metrics-window", "0.01", "--metrics-json", str(mpath)])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["buffers_processed"] == 12
    assert rep["windows"] >= 1
    assert rep["last_window"]["ascans_per_s"] > 0
    lines = [json.loads(l) for l in mpath.read_text().splitlines()]
    assert len(lines) == rep["windows"]
    assert lines[-1] == rep["last_window"]


def test_replay_packed12_wire_matches_uint16(tmp_path, capsys, small_raw_file):
    """The packed-12 wire path through the CLI produces the same processed
    stream as the uint16 container wire."""
    import numpy as np

    from octproz_tpu import native

    raw = np.fromfile(small_raw_file, np.uint16)
    packed_path = tmp_path / "packed.raw"
    native.pack_uint12(raw & 0x0FFF).tofile(packed_path)

    def run(args_):
        rc = main(args_)
        assert rc == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    base = ["--samples", "64", "--ascans", "8", "--bscans", "2",
            "--max-buffers", "2"]
    # mask to 12-bit for the comparison run too
    masked_path = tmp_path / "masked.raw"
    (raw & 0x0FFF).tofile(masked_path)

    def rec_args(tag):
        d = tmp_path / tag
        d.mkdir()
        return d, ["--record", "--record-processed", "--record-float32",
                   "--record-buffers", "2", "--record-dir", str(d),
                   "--record-name", tag, "--record-raw"][:9]

    da, ra = rec_args("u16")
    a = run(["replay", str(masked_path)] + base + ra)
    db, rb = rec_args("p12")
    b = run(["replay", str(packed_path), "--packed-12bit", "--keep-packed",
             "--wire-format", "packed12"] + base + rb)
    assert a["buffers_processed"] == b["buffers_processed"] == 2
    # the PROCESSED streams written through each wire are identical
    fa = sorted(da.glob("*_processed_float32_*.raw"))
    fb = sorted(db.glob("*_processed_float32_*.raw"))
    assert len(fa) == 1 and len(fb) == 1
    np.testing.assert_array_equal(np.fromfile(fa[0], np.float32),
                                  np.fromfile(fb[0], np.float32))

    with pytest.raises(SystemExit, match="packed"):
        # packed wire without a packed source is rejected
        main(["replay", str(packed_path), "--wire-format", "packed12"]
             + base)
    with pytest.raises(SystemExit, match="keep-packed requires"):
        main(["replay", str(packed_path), "--keep-packed"] + base)
    with pytest.raises(SystemExit, match="wire-format packed12"):
        main(["replay", str(packed_path), "--packed-12bit", "--keep-packed"]
             + base)


def _config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    import jax

    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda key, value: seen.append((key, value)))
    return seen


def test_compile_cache_uses_jax_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the CLI sets no
    directory of its own."""
    from octproz_tpu import cli

    seen = _config_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cli.enable_compilation_cache() == str(tmp_path)
    assert [v for k, v in seen if k == "jax_compilation_cache_dir"] == []


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    """Without the variable the cache is a fixed directory in the
    checkout (listed in .gitignore), not a home, temp or per-process
    path."""
    import os

    from octproz_tpu import cli

    seen = _config_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert cli.enable_compilation_cache() == want
    assert [v for k, v in seen if k == "jax_compilation_cache_dir"] == [want]
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
