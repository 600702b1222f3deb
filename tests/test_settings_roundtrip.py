"""Settings-file round-trip: every acquisition / processing / [tpu] build
knob / streaming / recording key survives config -> INI -> config identically
(the full sidebar.h:44-96 / settingsfilemanager.h:100-125 surface).
"""

import dataclasses
import json

import numpy as np
import pytest

from octproz_tpu.cli import main
from octproz_tpu.params import (AcqParams, FpnMode, Interpolation, ProcConfig,
                                WindowType)
from octproz_tpu.utils import configmap
from octproz_tpu.utils.settings import SettingsManager


def _roundtrip(tmp_path, acq, cfg, curve_kw=None, streaming=None,
               recording=None):
    path = str(tmp_path / "settings.ini")
    sm = SettingsManager(path)
    configmap.to_settings(sm, acq=acq, cfg=cfg, curve_kwargs=curve_kw,
                          streaming=streaming, recording=recording)
    sm.save()
    return configmap.from_settings(SettingsManager(path))


def test_default_config_roundtrip(tmp_path):
    acq, cfg = AcqParams(), ProcConfig()
    b = _roundtrip(tmp_path, acq, cfg)
    acq2, cfg2 = configmap.build_config(b)
    assert acq2 == acq
    assert cfg2 == cfg


@pytest.mark.parametrize("seed", range(6))
def test_random_config_roundtrip(tmp_path, seed):
    """Property test: random values in EVERY mapped field survive the
    round trip exactly."""
    rng = np.random.default_rng(seed)

    def flip():
        return bool(rng.integers(0, 2))

    acq = AcqParams(samples_per_line=int(rng.choice([256, 512, 1024, 1664])),
                    ascans_per_bscan=int(rng.integers(4, 1024)),
                    bscans_per_buffer=int(rng.integers(1, 512)),
                    buffers_per_volume=int(rng.integers(1, 16)),
                    bit_depth=int(rng.choice([8, 12, 16, 32])))
    cfg = ProcConfig(
        bitshift=flip(), background_removal=flip(),
        rolling_average_window=int(rng.integers(1, 256)),
        resampling=flip(),
        interpolation=Interpolation(rng.choice([m.value for m in Interpolation])),
        windowing=flip(), dispersion=flip(),
        fpn_mode=FpnMode(rng.choice([m.value for m in FpnMode])),
        bscans_for_noise=int(rng.integers(1, 16)),
        log_scaling=flip(),
        grayscale_min=float(np.round(rng.normal(), 6)),
        grayscale_max=float(np.round(60 + rng.normal(), 6)),
        multiplicator=float(np.round(rng.uniform(0.5, 2.0), 6)),
        addend=float(np.round(rng.normal(), 6)),
        bscan_flip=flip(), sinusoidal_correction=flip(),
        post_background_removal=flip(),
        post_background_weight=float(np.round(rng.uniform(), 6)),
        post_background_offset=float(np.round(rng.normal(), 6)),
        resample_via_matmul=flip(),
        compute_dtype=(cdt := str(rng.choice(["float32", "bfloat16"]))),
        matmul_precision=(prec := str(
            rng.choice(["default", "high", "highest"]))),
        fft_via_matmul=flip(),
        fold_backend=str(rng.choice(["pallas", "xla"])),
        output_dtype=str(rng.choice(["float32", "bfloat16"])),
    )
    curve_kw = dict(
        resample_coeffs=tuple(np.round(rng.normal(size=4), 6).tolist()),
        dispersion_coeffs=tuple(np.round(rng.normal(size=4), 6).tolist()),
        window_type=WindowType(rng.choice([m.value for m in WindowType])),
        window_center=float(np.round(rng.uniform(), 6)),
        window_fill_factor=float(np.round(rng.uniform(0.1, 1.0), 6)),
    )
    streaming = dict(stream_to_host=flip(),
                     streaming_skip=int(rng.integers(0, 8)))
    recording = dict(save_dir="/tmp/rec", name=f"r{seed}",
                     buffers_to_record=int(rng.integers(1, 64)),
                     save_raw=flip(), save_processed=flip(),
                     save_as_32bit_float=flip(),
                     start_with_first_buffer_of_volume=flip(),
                     save_meta=flip(), save_screenshots=flip(),
                     stop_after_record=flip(), description=f"desc {seed}")

    b = _roundtrip(tmp_path, acq, cfg, curve_kw, streaming, recording)
    acq2, cfg2 = configmap.build_config(b)
    assert acq2 == acq
    assert cfg2 == cfg
    assert b.curve_kwargs == curve_kw
    assert b.streaming == streaming
    assert b.recording == recording


def test_invalid_enum_value_names_key(tmp_path):
    path = str(tmp_path / "s.ini")
    sm = SettingsManager(path)
    sm.update_group("processing", {"window_type": "blackman"})
    sm.save()
    with pytest.raises(ValueError, match=r"\[processing\] window_type"):
        configmap.from_settings(SettingsManager(path))


def test_invalid_number_names_key(tmp_path):
    path = str(tmp_path / "s.ini")
    sm = SettingsManager(path)
    sm.update_group("processing", {"min": "abc"})
    sm.save()
    with pytest.raises(ValueError, match=r"\[processing\] min"):
        configmap.from_settings(SettingsManager(path))


def test_reference_boolean_fpn_keys(tmp_path):
    """The reference's PROC_FIXED_PATTERN_REMOVAL(+_CONTINUOUSLY) boolean
    pair maps onto FpnMode when the explicit mode key is absent."""
    path = str(tmp_path / "s.ini")
    sm = SettingsManager(path)
    sm.update_group("processing", {"fixed_pattern_removal": "true",
                                   "fixed_pattern_removal_continuously": "1"})
    sm.save()
    b = configmap.from_settings(SettingsManager(path))
    assert b.cfg_kwargs["fpn_mode"] == FpnMode.CONTINUOUS
    sm.update_group("processing", {"fixed_pattern_removal_continuously": "0"})
    sm.save()
    b = configmap.from_settings(SettingsManager(path))
    assert b.cfg_kwargs["fpn_mode"] == FpnMode.ONCE


# ---------------------------------------------------------------------------
# CLI integration: settings save/show + --settings application and override
# ---------------------------------------------------------------------------

def test_cli_settings_save_show_roundtrip(tmp_path, capsys):
    ini = tmp_path / "cfg.ini"
    rc = main(["settings", "save", str(ini),
               "--samples", "256", "--ascans", "16", "--bscans", "8",
               "--interpolation", "lanczos", "--window-type", "flattop",
               "--fpn", "continuous", "--grayscale-max", "72.5",
               "--disp-coeffs", "0", "0", "7.5", "-1.25",
               "--compute-dtype", "bfloat16", "--fold-backend", "xla"])
    assert rc == 0 and ini.exists()
    assert main(["settings", "show", str(ini)]) == 0
    shown = json.loads(capsys.readouterr().out)
    assert shown["acquisition"]["samples_per_line"] == 256
    assert shown["processing"]["interpolation"] == "lanczos"
    assert shown["processing"]["fpn_mode"] == "continuous"
    assert shown["processing"]["grayscale_max"] == 72.5
    assert shown["processing"]["fold_backend"] == "xla"
    assert shown["processing"]["compute_dtype"] == "bfloat16"
    assert shown["curves"]["window_type"] == "flattop"
    assert shown["curves"]["dispersion_coeffs"] == [0.0, 0.0, 7.5, -1.25]


def test_cli_settings_drive_process_and_flags_override(tmp_path):
    """process runs entirely off a settings file (no geometry flags), and an
    explicit CLI flag overrides the file value even when the flag equals
    another default."""
    n, asc, bsc = 128, 8, 4
    k = np.arange(n)
    spec = 1000.0 + 400.0 * np.cos(2 * np.pi * 20 * k / n)
    vol = np.tile(spec, (1, bsc, asc, 1)).astype(np.uint16)
    inp = tmp_path / "in.raw"
    vol.tofile(inp)

    ini = tmp_path / "cfg.ini"
    assert main(["settings", "save", str(ini),
                 "--samples", str(n), "--ascans", str(asc),
                 "--bscans", str(bsc), "--fpn", "off",
                 "--compute-dtype", "bfloat16",
                 "--grayscale-max", "80"]) == 0

    out1 = tmp_path / "o1.raw"
    assert main(["process", str(inp), "--settings", str(ini),
                 "--output", str(out1)]) == 0
    a = np.fromfile(out1, np.float32).reshape(bsc, asc, n // 2)
    assert np.isfinite(a).all()

    # explicit flag wins over the file: --compute-dtype float32 (the ProcConfig
    # default!) must override the file's bfloat16
    from octproz_tpu.cli import build_parser, _build_config

    args = build_parser().parse_args(
        ["process", str(inp), "--settings", str(ini),
         "--compute-dtype", "float32"])
    _, cfg, _ = _build_config(args)
    assert cfg.compute_dtype == "float32"
    assert cfg.grayscale_max == 80.0  # non-overridden file value applies

    args = build_parser().parse_args(["process", str(inp), "--settings",
                                      str(ini)])
    _, cfg, _ = _build_config(args)
    assert cfg.compute_dtype == "bfloat16"  # file value without the flag


def test_partial_coefficient_keys_keep_identity_defaults(tmp_path):
    """A file specifying only resampling_c2 overlays it on the identity
    curve (0, N-1, 0, 0) instead of zero-filling c1 (which would collapse
    the curve to sample 0)."""
    ini = tmp_path / "partial.ini"
    ini.write_text("[processing]\nresampling_c2 = 20.0\n")
    b = configmap.from_settings(SettingsManager(str(ini)))
    assert b.curve_kwargs["resample_coeffs"] == (None, None, 20.0, None)

    import argparse

    from octproz_tpu.cli import _build_config

    ns = argparse.Namespace(settings=str(ini), samples=128, ascans=8,
                            bscans=4)
    acq, cfg, model_kw = _build_config(ns)
    assert model_kw["resample_coeffs"] == (0.0, 127.0, 20.0, 0.0)


def test_legacy_processing_group_keys_still_apply(tmp_path):
    """Keys the round-2 CLI read from [processing] (klin_coeffs +
    dtype/precision) keep working; canonical locations win when both
    are present."""
    ini = tmp_path / "legacy.ini"
    ini.write_text("[processing]\n"
                   "klin_coeffs = 1.0,100.0,2.0,3.0\n"
                   "compute_dtype = bfloat16\n"
                   "matmul_precision = high\n")
    b = configmap.from_settings(SettingsManager(str(ini)))
    assert b.curve_kwargs["resample_coeffs"] == (1.0, 100.0, 2.0, 3.0)
    assert b.cfg_kwargs["compute_dtype"] == "bfloat16"
    assert b.cfg_kwargs["matmul_precision"] == "high"

    both = tmp_path / "both.ini"
    both.write_text("[processing]\ncompute_dtype = bfloat16\n"
                    "[tpu]\ncompute_dtype = float32\n")
    b2 = configmap.from_settings(SettingsManager(str(both)))
    assert b2.cfg_kwargs["compute_dtype"] == "float32"  # canonical wins


def test_settings_save_never_loads_the_base_custom_curve(tmp_path, capsys):
    """save with a base file whose custom_resampling_filepath no longer
    exists must still succeed (the CSV is passed through, never loaded)."""
    base = tmp_path / "base.ini"
    base.write_text("[acquisition]\nsamples_per_line = 128\n"
                    "ascans_per_bscan = 8\nbscans_per_buffer = 4\n"
                    "[processing]\ncustom_resampling = 1\n"
                    "custom_resampling_filepath = /nope/gone.csv\n")
    out = tmp_path / "out.ini"
    rc = main(["settings", "save", str(out), "--settings", str(base),
               "--klin-curve-csv", str(tmp_path / "new.csv")])
    assert rc == 0
    saved = SettingsManager(str(out)).get_group("processing")
    assert saved["custom_resampling_filepath"] == str(tmp_path / "new.csv")


def test_settings_with_removed_knobs_load(tmp_path):
    """A settings file written before the kernel-tuning knobs went
    (fold_concat, fold_k_split, fast_log, pallas_tile, fused_scale,
    use_pallas_prep) still loads: those keys are ignored like any unknown
    key, and the knobs that remain are read."""
    ini = tmp_path / "old.ini"
    ini.write_text("[tpu]\nfold_concat = 1\nfold_k_split = 4\nfast_log = 1\n"
                   "pallas_tile = 512\nfused_scale = 0\nuse_pallas_prep = 1\n"
                   "compute_dtype = bfloat16\nfold_backend = xla\n")
    bundle = configmap.from_settings(SettingsManager(str(ini)))
    assert bundle.cfg_kwargs == {"compute_dtype": "bfloat16",
                                 "fold_backend": "xla"}
    assert ProcConfig(**bundle.cfg_kwargs).compute_dtype == "bfloat16"


def test_to_settings_accepts_partial_coefficient_tuples(tmp_path):
    """from_settings produces None slots for partial files; to_settings
    must round-trip them (skip the unspecified slots), not crash."""
    ini = tmp_path / "p.ini"
    ini.write_text("[processing]\nresampling_c1 = 430.0\n")
    b = configmap.from_settings(SettingsManager(str(ini)))
    out = SettingsManager(str(tmp_path / "out.ini"))
    configmap.to_settings(out, curve_kwargs=b.curve_kwargs)
    proc = out.get_group("processing")
    assert proc["resampling_c1"] == "430.0"
    assert "resampling_c0" not in proc


def test_post_background_filepath_roundtrip_and_load(tmp_path):
    """PROC_POST_BACKGROUND_FILEPATH (sidebar.h:91): the recorded
    background curve file round-trips and is applied to the config."""
    bg = tmp_path / "bg.csv"
    bg.write_text("".join(f"{i};0.25\n" for i in range(64)))
    ini = tmp_path / "s.ini"
    ini.write_text("[acquisition]\nsamples_per_line = 128\n"
                   "ascans_per_bscan = 8\nbscans_per_buffer = 4\n"
                   "[processing]\npost_processing_background_removal = 1\n"
                   f"post_processing_background_filepath = {bg}\n")
    b = configmap.from_settings(SettingsManager(str(ini)))
    assert b.curve_kwargs["post_background_filepath"] == str(bg)

    import argparse

    from octproz_tpu.cli import _build_config

    ns = argparse.Namespace(settings=str(ini))
    acq, cfg, model_kw = _build_config(ns)
    assert cfg.post_background_removal
    np.testing.assert_allclose(model_kw["post_background"],
                               np.full(64, 0.25, np.float32))
    # the writer puts it back
    out = SettingsManager(str(tmp_path / "out.ini"))
    configmap.to_settings(out, curve_kwargs=b.curve_kwargs)
    assert out.get_group("processing")[
        "post_processing_background_filepath"] == str(bg)


def test_settings_preserve_plugin_key_case(tmp_path):
    """Per-plugin groups hold arbitrary keys: 'filePath' must round-trip,
    not be silently lowercased (QSettings semantics)."""
    sm = SettingsManager(str(tmp_path / "s.ini"))
    sm.set_group("system:demo", {"filePath": "/x.raw", "waitTimeUs": 10})
    sm.save()
    back = SettingsManager(str(tmp_path / "s.ini")).get_group("system:demo")
    assert back == {"filePath": "/x.raw", "waitTimeUs": "10"}


def test_legacy_klin_coeffs_validation_names_the_key(tmp_path):
    ini = tmp_path / "bad.ini"
    ini.write_text("[processing]\nklin_coeffs = 0, 255\n")
    with pytest.raises(ValueError, match=r"klin_coeffs.*4"):
        configmap.from_settings(SettingsManager(str(ini)))
