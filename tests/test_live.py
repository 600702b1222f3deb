"""Tests: HTTP live viewer (GLWindow2D / info-box analog)."""

import json
import urllib.error
import urllib.request

import numpy as np

from octproz_tpu.runtime import ThroughputStats
from octproz_tpu.viz.live import LiveView


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_serves_page_and_frames():
    live = LiveView(port=0, throttle_s=0.0)
    try:
        vol = np.zeros((4, 8, 16), np.float32)
        vol[:, :, 5] = 1.0  # bright layer at depth 5
        live.update(vol, 0)
        live.update_stats(ThroughputStats(ascans_per_s=1e6, buffers_per_s=10,
                                          bscans_per_s=100, volumes_per_s=1,
                                          mb_per_s=50, buffer_mb=5,
                                          buffers_processed=7))

        status, ctype, body = _get(live.url)
        assert status == 200 and "text/html" in ctype
        assert b"octproz_tpu live" in body

        status, ctype, body = _get(live.url + "bscan.png")
        assert status == 200 and ctype == "image/png"
        assert body[:4] == b"\x89PNG"

        status, ctype, body = _get(live.url + "enface.png")
        assert status == 200 and body[:4] == b"\x89PNG"

        status, _, body = _get(live.url + "ascan.json")
        vals = json.loads(body)["values"]
        assert len(vals) == 16 and vals[5] == 1.0

        status, _, body = _get(live.url + "stats.json")
        stats = json.loads(body)
        assert stats["ascans_per_s"] == 1e6
        assert "volumes/s" in stats["info"]
    finally:
        live.close()


def test_throttle_drops_intermediate_frames():
    live = LiveView(port=0, throttle_s=10.0)
    try:
        vol = np.zeros((2, 4, 8), np.float32)
        for _ in range(5):
            live.update(vol, 0)
        assert live.frames_rendered == 1  # 80 ms-style redraw throttle
    finally:
        live.close()


def test_quantized_input_and_lut():
    live = LiveView(port=0, lut="fire", throttle_s=0.0)
    try:
        vol = np.full((2, 4, 8), 200, np.uint8)
        live.update(vol, 0)
        status, _, body = _get(live.url + "bscan.png")
        assert status == 200 and body[:4] == b"\x89PNG"
    finally:
        live.close()


def test_attach_chains_engine_callbacks():
    class FakeEngine:
        on_processed = None
        on_metrics = None

    calls = []
    eng = FakeEngine()
    eng.on_processed = lambda v, n: calls.append(("prev", n))
    live = LiveView(port=0, throttle_s=0.0)
    try:
        live.attach(eng)
        eng.on_processed(np.zeros((1, 2, 4), np.float32), 3)
        assert calls == [("prev", 3)]
        assert live.frames_rendered == 1
        eng.on_metrics(ThroughputStats(buffers_processed=1))
        status, _, body = _get(live.url + "stats.json")
        assert json.loads(body)["buffers_processed"] == 1
    finally:
        live.close()


def test_volume_raycast_pinned_to_cpu_device(monkeypatch):
    """The live volume raycast must pass an explicit CPU jax device to
    render_volume: the serving path may never dispatch onto the session
    accelerator (glwindow3d.cpp:316-323 — display never stalls
    processing)."""
    import jax

    from octproz_tpu.viz import render as render_mod

    seen = {}
    real = render_mod.render_volume

    def spy(volume, *a, **kw):
        seen["device"] = kw.get("device")
        return real(volume, *a, **kw)

    monkeypatch.setattr(render_mod, "render_volume", spy)

    class FakeAssembler:
        volume = np.random.default_rng(0).random((4, 4, 8)).astype(np.float32)

    live = LiveView(port=0, throttle_s=0.0, volume_render=True,
                    volume_size=16)
    try:
        live._assembler = FakeAssembler()
        png = live._render_assembled_volume()
        assert png is not None and png[:4] == b"\x89PNG"
        assert seen["device"] is not None
        assert seen["device"].platform == "cpu"
        assert seen["device"] in jax.local_devices(backend="cpu")
    finally:
        live.close()


def test_page_script_structure():
    """No JS engine ships in the test image, so pin the page's structural
    invariants instead: balanced delimiters in the script and every
    getElementById target present in the HTML (catches template edits that
    rename/remove an element the script still drives)."""
    import re

    from octproz_tpu.viz.live import _PAGE

    script = _PAGE.split("<script>")[1].split("</script>")[0]
    html = _PAGE.split("<script>")[0]
    for o, c in (("{", "}"), ("(", ")"), ("[", "]")):
        assert script.count(o) == script.count(c), f"unbalanced {o}{c}"
    ids = set(re.findall(r"id=\"([\w-]+)\"", html))
    # literal-id references only; ids built by concatenation (the dynamic
    # pane_<name> divs, the bar readouts) resolve at runtime
    wanted = set(re.findall(r"getElementById\('([\w-]+)'\)", script))
    missing = {w for w in wanted if w not in ids}
    assert not missing, f"script references missing elements: {missing}"
    # ids built by string concatenation resolve at runtime; sanity-check the
    # two the cursor readout composes
    assert {"bscanBar", "enfaceBar"} <= ids


def test_interactive_render_control():
    """POST /render drives the live raycast: all 7 modes reachable with
    viewpoint/threshold/gamma/step/lut control (trackball + per-frame
    mode uniforms, glwindow3d.cpp:266-272,300-360,
    controlpanel.h:67-84).  Each accepted POST re-renders immediately and
    the pane images differ across viewpoints."""

    class FakeAssembler:
        volume = np.zeros((6, 6, 12), np.float32)
        volume[1:3, 1:3, 2:5] = 0.9  # an off-center bright blob

    live = LiveView(port=0, throttle_s=0.0, volume_render=True,
                    volume_size=24)
    try:
        live._assembler = FakeAssembler()
        # state surface
        _, _, body = _get(live.url + "render.json")
        st0 = json.loads(body)
        assert len(st0["modes"]) == 7 and st0["mode"] == "mip"
        # every mode renders via POST
        pngs = {}
        for mode in st0["modes"]:
            st, r = _post(live.url + "render", {"mode": mode})
            assert st == 200, mode
            assert r["reply"]["mode"] == mode
            _, _, png = _get(live.url + "volume.png")
            assert png[:4] == b"\x89PNG"
            pngs[mode] = png
        # trackball: a different viewpoint produces a different image
        st, r = _post(live.url + "render",
                      {"mode": "mip", "yaw": 2.2, "pitch": -0.8})
        assert st == 200 and abs(r["reply"]["yaw"] - 2.2) < 1e-9
        _, _, png2 = _get(live.url + "volume.png")
        assert png2 != pngs["mip"]
        # uniforms + lut round-trip; step length clamped to an
        # interactive range
        st, r = _post(live.url + "render",
                      {"threshold": 0.4, "gamma": 1.5,
                       "step_length": 1e-6, "lut": "fire"})
        assert st == 200
        assert r["reply"]["threshold"] == 0.4
        assert r["reply"]["step_length"] >= 0.004
        assert r["reply"]["lut"] == "fire"
        # invalid mode / lut are loud
        st, r = _post(live.url + "render", {"mode": "nope"})
        assert st == 400 and "error" in r
        st, r = _post(live.url + "render", {"lut": "nope"})
        assert st == 400 and "error" in r
    finally:
        live.close()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _engine_with_live(tmp_path, **live_kw):
    """Real StreamingEngine + attached LiveView (not run; the controller
    mutates it directly like a live session would)."""
    from octproz_tpu.extensions.peaks import PeakDetectorExtension
    from octproz_tpu.extensions.statistics import ImageStatisticsExtension
    from octproz_tpu.io.source import SyntheticSource
    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.params import (AcqParams, FpnMode, Interpolation,
                                    ProcConfig)
    from octproz_tpu.plugins import ExtensionManager
    from octproz_tpu.runtime import StreamingEngine

    acq = AcqParams(samples_per_line=64, ascans_per_bscan=8,
                    bscans_per_buffer=2, buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                     windowing=True, fpn_mode=FpnMode.OFF, log_scaling=True)
    model = FdOctModel(acq, cfg, resample_coeffs=(0.0, 63.0, 0.0, 0.0))
    exts = ExtensionManager()
    exts.add(ImageStatisticsExtension())
    exts.add(PeakDetectorExtension())
    eng = StreamingEngine(model, SyntheticSource(acq, n_buffers=2),
                          extensions=exts, stream_to_host=True)
    live = LiveView(port=0, throttle_s=0.0, **live_kw)
    live.attach(eng)
    return eng, live


def test_control_panel_sidebar_parity_round_trips(tmp_path):
    """Every sidebar-parity control reachable from the web UI round-trips
    through POST /control: window type/center/fill,
    interpolation, FPN mode, streaming skip, recording start/stop,
    extension toggles."""
    eng, live = _engine_with_live(tmp_path)
    try:
        url = live.url + "control"
        # window geometry (sidebar window settings)
        st, r = _post(url, {"command": "set_window", "type": "gauss",
                            "center": 0.4, "fill_factor": 0.8})
        assert st == 200 and r["reply"] == "ok"
        # interpolation (recompiles)
        st, r = _post(url, {"command": "set_interpolation", "type": "cubic"})
        assert st == 200 and eng.model.cfg.interpolation.value == "cubic"
        # FPN mode (recompiles)
        st, r = _post(url, {"command": "set_fpn_mode", "mode": "continuous"})
        assert st == 200 and eng.model.cfg.fpn_mode.value == "continuous"
        # streaming skip
        st, r = _post(url, {"command": "set_streaming", "skip": 3,
                            "enabled": True})
        assert st == 200 and eng.streaming_skip == 3 and eng.stream_to_host
        # params.json reflects the new state (panel seeding)
        _, _, body = _get(live.url + "params.json")
        p = json.loads(body)
        assert p["window_type"] == "gauss"
        assert p["interpolation"] == "cubic"
        assert p["streaming_skip"] == 3
        # recording start + status
        st, r = _post(url, {"command": "start_recording", "name": "t",
                            "dir": str(tmp_path), "buffers": 1,
                            "processed": True, "meta": False})
        assert st == 200 and eng.recording
        st, r = _post(url, {"command": "recording_status"})
        assert r["reply"]["recording"] and r["reply"]["processed"]
        st, r = _post(url, {"command": "start_recording"})
        assert st == 400 and "in progress" in r["error"]
        # extension toggles
        st, r = _post(url, {"command": "activate_extension",
                            "name": "image-statistics"})
        assert st == 200
        st, r = _post(url, {"command": "list_extensions"})
        assert r["reply"]["image-statistics"] is True
        # stats.json surfaces the recording flag for the REC indicator
        _, _, body = _get(live.url + "stats.json")
        assert json.loads(body)["recording"] is True
    finally:
        live.close()
        eng.source.close() if hasattr(eng.source, "close") else None


def test_extension_output_pane(tmp_path):
    """Active extensions' latest results are served at /extension.json in
    the generic get_output() shapes (the statistics
    histogram and peak list are now CONSUMERS of the same protocol every
    extension gets)."""
    eng, live = _engine_with_live(tmp_path)
    try:
        for name in ("image-statistics", "peak-detector"):
            eng.extensions.extensions[name].activate()
        eng.run()  # feeds processed data through the extensions
        _, _, body = _get(live.url + "extension.json?name=image-statistics")
        out = json.loads(body)
        assert out["active"] and len(out["series"]["histogram"]) == 64
        assert out["scalars"]["maximum"] >= out["scalars"]["minimum"]
        _, _, body = _get(live.url + "extension.json?name=peak-detector")
        out = json.loads(body)
        assert isinstance(out.get("table"), list)
        assert out["scalars"]["n_peaks"] == len(out["table"])
        # unknown extension -> 404
        try:
            _get(live.url + "extension.json?name=nope")
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        live.close()


def test_third_party_extension_pane_zero_viewer_edits(tmp_path):
    """A brand-new extension implementing get_output() gets a hosted pane
    with NO viewer edits."""
    from octproz_tpu.plugins import Extension

    class FreshExtension(Extension):
        name = "fresh"
        wants_processed_data = True

        def __init__(self):
            super().__init__()
            self.n = 0

        def processed_data_received(self, *a):
            self.n += 1

        def get_output(self):
            return {"scalars": {"frames": self.n},
                    "series": {"ramp": [0.0, 0.5, 1.0]},
                    "table": [{"k": "a", "v": 1}],
                    "text": "hello",
                    "image": [[0.0, 1.0], [1.0, 0.0]]}

    eng, live = _engine_with_live(tmp_path)
    try:
        ext = FreshExtension()
        eng.extensions.add(ext)
        ext.activate()
        eng.run()
        _, _, body = _get(live.url + "extension.json?name=fresh")
        out = json.loads(body)
        assert out["scalars"]["frames"] == 2
        assert out["series"]["ramp"] == [0.0, 0.5, 1.0]
        assert out["table"] == [{"k": "a", "v": 1}]
        assert out["text"] == "hello"
        assert out["image"][0] == [0.0, 1.0]
    finally:
        live.close()


def test_extension_get_output_failure_is_contained(tmp_path):
    """A get_output that raises, or returns a non-dict, yields an error
    field — not a dead pane or a handler 500."""
    from octproz_tpu.plugins import Extension

    class BrokenExtension(Extension):
        name = "broken"

        def get_output(self):
            raise RuntimeError("boom")

    class ListExtension(Extension):
        name = "listy"

        def get_output(self):
            return [1, 2, 3]  # protocol misuse: must be a dict

    eng, live = _engine_with_live(tmp_path)
    try:
        for ext in (BrokenExtension(), ListExtension()):
            eng.extensions.add(ext)
            ext.activate()
        _, _, body = _get(live.url + "extension.json?name=broken")
        assert "boom" in json.loads(body)["error"]
        _, _, body = _get(live.url + "extension.json?name=listy")
        assert "must return a dict" in json.loads(body)["error"]
    finally:
        live.close()


def test_extension_output_reserved_keys_namespaced(tmp_path):
    """An extension's own name/active/error keys must not clobber the
    pane metadata: they come back as ext_*."""
    from octproz_tpu.plugins import Extension

    class StatusExtension(Extension):
        name = "status"

        def get_output(self):
            return {"error": "fit diverged", "active": False,
                    "scalars": {"ok": np.bool_(True)}}

    eng, live = _engine_with_live(tmp_path)
    try:
        ext = StatusExtension()
        eng.extensions.add(ext)
        ext.activate()
        _, _, body = _get(live.url + "extension.json?name=status")
        out = json.loads(body)
        assert out["active"] is True and "error" not in out
        assert out["ext_error"] == "fit diverged"
        assert out["ext_active"] is False
        assert out["scalars"]["ok"] is True  # np.bool_ serialized
    finally:
        live.close()


def test_extension_output_serializes_numpy(tmp_path):
    """numpy scalars/arrays nested in get_output()'s dicts — the natural
    product of numpy analysis — must serialize, not 500 the pane."""
    from octproz_tpu.plugins import Extension

    class NumpyExtension(Extension):
        name = "numpy-out"

        def get_output(self):
            return {"scalars": {"mean": np.float32(3.25),
                                "count": np.int64(7)},
                    "series": {"profile": np.linspace(0, 1, 4)}}

    eng, live = _engine_with_live(tmp_path)
    try:
        ext = NumpyExtension()
        eng.extensions.add(ext)
        ext.activate()
        _, _, body = _get(live.url + "extension.json?name=numpy-out")
        out = json.loads(body)
        assert out["scalars"] == {"mean": 3.25, "count": 7}
        assert out["series"]["profile"] == [0.0, 1 / 3, 2 / 3, 1.0]
    finally:
        live.close()


def test_display_manipulation_and_data_cursor():
    """POST /display (frame selection, avg/MIP, physical scale) and the
    /pixel data-cursor endpoint (GLWindow2D interactivity
    analog; zoom/pan/rotate/markers are client-side canvas transforms over
    these server surfaces)."""
    live = LiveView(port=0, throttle_s=0.0)
    try:
        st, r = _post(live.url + "display",
                      {"bscan_nr": 1, "frames": 2, "mip": True,
                       "depth_mm": 2.5, "width_mm": 10.0})
        assert st == 200
        assert r["reply"] == {"bscan_nr": 1, "enface_depth": 0, "frames": 2,
                              "mip": True, "depth_mm": 2.5, "width_mm": 10.0}
        _, _, body = _get(live.url + "display.json")
        assert json.loads(body)["mip"] is True

        vol = np.zeros((4, 8, 16), np.float32)
        vol[1, 3, 5] = 0.75    # lone bright voxel in B-scan 1
        vol[2, :, :] = 0.5     # MIP over frames 1..2 sees this everywhere
        live.update(vol, 0)
        # B-scan displayed orientation: depth vertical (row 0 = deepest),
        # A-scan horizontal -> pixel (x=ascan 3, y=depth 15-5)
        st, r = _post(live.url + "display", {"mip": True})  # keep mip
        _, _, body = _get(live.url + "pixel?img=bscan&x=3&y=10")
        v = json.loads(body)["value"]
        assert v == 0.75
        _, _, body = _get(live.url + "pixel?img=bscan&x=0&y=0")
        assert json.loads(body)["value"] == 0.5  # the MIP floor frame
        # out of range -> null value
        _, _, body = _get(live.url + "pixel?img=bscan&x=999&y=0")
        assert json.loads(body)["value"] is None
    finally:
        live.close()
