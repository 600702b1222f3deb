"""Runtime plugin discovery/loading.

The reference loads acquisition systems and extensions from shared
libraries at startup (octprozapp.cpp:99-174, QPluginLoader); here third
parties ship Python packages loaded by module-path spec, settings key, or
installed entry points — these tests drive all three against the
OUT-OF-TREE example package in tests/data/extplugin_pkg (which never edits
the framework).
"""

import io
import os
import sys

import numpy as np
import pytest

from octproz_tpu.io.systems import SystemRegistry
from octproz_tpu.plugins import (ENTRY_POINT_GROUP, Extension,
                                 ExtensionManager, PluginContext,
                                 discover_entry_point_plugins, load_plugin,
                                 load_plugins)

PKG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "data", "extplugin_pkg")


@pytest.fixture(autouse=True)
def _plugin_path():
    sys.path.insert(0, PKG_DIR)
    try:
        yield
    finally:
        sys.path.remove(PKG_DIR)
        sys.modules.pop("myoct_plugin", None)


def _ctx():
    return PluginContext(extensions=ExtensionManager(),
                         systems=SystemRegistry())


def test_load_module_default_entry():
    ctx = _ctx()
    load_plugin("myoct_plugin", ctx)
    assert ("system", "ramp") in ctx.loaded
    assert ("extension", "buffer_counter") in ctx.loaded
    assert "buffer_counter" in ctx.extensions.extensions
    assert "ramp" in ctx.systems.names


def test_load_explicit_factory_attr():
    ctx = _ctx()
    load_plugin("myoct_plugin:octproz_plugin", ctx)
    assert "ramp" in ctx.systems.names


def test_load_extension_class_target():
    """A spec naming an Extension subclass directly is instantiated and
    registered (the qobject_cast<Extension*> analog)."""
    ctx = _ctx()
    load_plugin("myoct_plugin:BufferCounterExtension", ctx)
    assert ctx.loaded == [("extension", "buffer_counter")]


def test_missing_default_entry_is_loud():
    with pytest.raises(ValueError, match="octproz_plugin"):
        load_plugin("numpy", _ctx())


def test_bad_target_type_is_loud():
    with pytest.raises(TypeError, match="plugin target"):
        load_plugin("numpy:__version__", _ctx())


def test_extension_settings_group_round_trip():
    """register_extension feeds the plugin its [extension:NAME] settings
    group (plugin.h:43-45 settingsLoaded analog)."""
    class Groups:
        def get(self, key, default=None):
            return ({"gain": "3"} if key == "extension:buffer_counter"
                    else default)

    ctx = PluginContext(extensions=ExtensionManager(),
                        systems=SystemRegistry(), settings=Groups())
    load_plugin("myoct_plugin", ctx)
    assert ctx.extensions.extensions["buffer_counter"].settings == {"gain": "3"}


def test_loaded_system_and_extension_end_to_end():
    """A loaded system feeds a loaded extension through the real streaming
    engine — the full third-party path with zero framework edits."""
    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.params import ProcConfig
    from octproz_tpu.runtime import StreamingEngine

    ctx = _ctx()
    load_plugins(["myoct_plugin"], ctx, entry_points=False)
    src = ctx.systems.activate("ramp")
    ext = ctx.extensions.extensions["buffer_counter"]
    ext.activate()
    model = FdOctModel(src.acq, ProcConfig(),
                       resample_coeffs=(0.0, src.acq.samples_per_line - 1.0,
                                        0.0, 0.0))
    eng = StreamingEngine(model, src, extensions=ctx.extensions,
                          stream_to_host=True)
    assert eng.run() == 3
    assert ext.count == 3
    assert ext.get_output()["scalars"]["buffers_seen"] == 3


def test_entry_point_discovery():
    """Installed distributions advertising [octproz_tpu.plugins] entry
    points load automatically — simulated with a fake distribution on
    sys.meta_path (no pip install needed)."""
    from importlib import metadata

    class FakeDist(metadata.Distribution):
        def read_text(self, filename):
            if filename == "METADATA":
                return "Metadata-Version: 2.1\nName: fakeplug\nVersion: 1.0\n"
            if filename == "entry_points.txt":
                return (f"[{ENTRY_POINT_GROUP}]\n"
                        "myplug = myoct_plugin:octproz_plugin\n")
            return None

        def locate_file(self, path):
            return path

    class Finder:
        def find_distributions(self, context=None):
            return [FakeDist()]

    sys.meta_path.append(Finder())
    try:
        ctx = _ctx()
        names = discover_entry_point_plugins(ctx)
        assert "myplug" in names
        assert "ramp" in ctx.systems.names
        assert "buffer_counter" in ctx.extensions.extensions
    finally:
        sys.meta_path.pop()


def test_entry_point_failure_is_contained(capsys):
    """One broken installed distribution must not take the session down
    (octprozapp.cpp:170-173 tolerance): the bad entry point is skipped
    loudly, good ones still load."""
    from importlib import metadata

    class Dist(metadata.Distribution):
        def __init__(self, name, target):
            self._name, self._target = name, target

        def read_text(self, filename):
            if filename == "METADATA":
                return f"Metadata-Version: 2.1\nName: {self._name}\n" \
                       "Version: 1.0\n"
            if filename == "entry_points.txt":
                return (f"[{ENTRY_POINT_GROUP}]\n"
                        f"{self._name} = {self._target}\n")
            return None

        def locate_file(self, path):
            return path

    class Finder:
        def find_distributions(self, context=None):
            return [Dist("badplug", "module_that_does_not_exist:thing"),
                    Dist("goodplug", "myoct_plugin:octproz_plugin")]

    sys.meta_path.append(Finder())
    try:
        ctx = _ctx()
        names = discover_entry_point_plugins(ctx)
        assert names == ["goodplug"]
        assert "ramp" in ctx.systems.names
        assert "failed to load and was skipped" in capsys.readouterr().err
    finally:
        sys.meta_path.pop()


def test_cli_process_feeds_loaded_extensions(tmp_path, capsys):
    """`process --plugins` must FEED the loaded extensions, not just
    announce them (review r5): a plugin extension that records its calls
    to a file observes both raw and processed buffers."""
    import numpy as np

    from octproz_tpu.cli import main

    sentinel = tmp_path / "calls.txt"
    pkg = tmp_path / "procplug.py"
    pkg.write_text(f"""
from octproz_tpu.plugins import Extension

class Counter(Extension):
    name = "counter"
    wants_raw_data = True
    wants_processed_data = True

    def raw_data_received(self, buffer, bit_depth, *rest):
        with open({str(sentinel)!r}, "a") as f:
            f.write(f"raw {{buffer.shape}} {{bit_depth}}\\n")

    def processed_data_received(self, buffer, bit_depth, *rest):
        with open({str(sentinel)!r}, "a") as f:
            f.write(f"proc {{buffer.shape}} {{bit_depth}}\\n")

octproz_plugin = Counter
""")
    raw = np.random.default_rng(0).integers(
        0, 4095, size=(2, 4, 8, 64)).astype(np.uint16)
    raw_path = tmp_path / "in.raw"
    raw.tofile(raw_path)
    sys.path.insert(0, str(tmp_path))
    try:
        rc = main(["--platform", "cpu", "process", str(raw_path),
                   "--samples", "64", "--ascans", "8", "--bscans", "4",
                   "--plugins", "procplug", "--no-entry-point-plugins"])
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("procplug", None)
    assert rc == 0
    lines = sentinel.read_text().strip().splitlines()
    raws = [l for l in lines if l.startswith("raw")]
    procs = [l for l in lines if l.startswith("proc")]
    assert len(raws) == 2 and len(procs) == 2
    assert "(4, 8, 64) 12" in raws[0]
    assert "(4, 8, 32) 12" in procs[0]


def test_settings_file_plugins_group(tmp_path):
    """[plugins] load= in the settings INI is parsed into the bundle."""
    from octproz_tpu.utils.configmap import from_settings
    from octproz_tpu.utils.settings import SettingsManager

    ini = tmp_path / "s.ini"
    ini.write_text("[plugins]\nload = myoct_plugin, other.mod:factory\n")
    b = from_settings(SettingsManager(str(ini)))
    assert b.plugins == ["myoct_plugin", "other.mod:factory"]


def test_settings_save_round_trips_plugins(tmp_path, capsys):
    """`settings save --plugins X` writes [plugins] load= so the saved
    file reproduces the plugin set on load (review r5: the save/load
    round-trip was asymmetric for exactly this key)."""
    from octproz_tpu.cli import main
    from octproz_tpu.utils.configmap import from_settings
    from octproz_tpu.utils.settings import SettingsManager

    ini = tmp_path / "s.ini"
    rc = main(["--platform", "cpu", "settings", "save", str(ini),
               "--samples", "64", "--ascans", "8", "--bscans", "2",
               "--plugins", "myoct_plugin", "--no-entry-point-plugins"])
    assert rc == 0
    b = from_settings(SettingsManager(str(ini)))
    assert b.plugins == ["myoct_plugin"]


def test_cli_replay_with_plugin_system(tmp_path, capsys):
    """End-to-end CLI: --plugins loads the package, system:ramp activates
    the third-party acquisition system, the stream runs."""
    import json

    from octproz_tpu.cli import main

    rc = main(["--platform", "cpu", "replay", "system:ramp",
               "--plugins", "myoct_plugin", "--no-entry-point-plugins"])
    assert rc == 0
    out = capsys.readouterr()
    assert "plugin loaded: system 'ramp'" in out.err
    assert "plugin loaded: extension 'buffer_counter'" in out.err
    report = json.loads(out.out.strip().splitlines()[-1])
    assert report["buffers_processed"] == 3
