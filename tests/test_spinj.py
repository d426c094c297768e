"""spinj-variant tests: triggered batch capture, averages keys, offline
hand-off, output B-scan rebinning."""

import numpy as np
import pytest

from fdoct_tpu.config import PipelineConfig
from fdoct_tpu.session import Session
from fdoct_tpu.sinks import RunWriter
from fdoct_tpu.sources.synthetic import SyntheticSource


@pytest.fixture()
def cfg():
    return PipelineConfig(width=64, height=8, binvalue=1, averages=2,
                          numfftpoints=128, numdisplaypoints=40,
                          manualaverages=3, dtype="float64")


@pytest.fixture()
def src(cfg):
    return SyntheticSource(height=8, width=64, depths_um=(20.0,))


def feed(session, src, n):
    it = iter(src.frames())
    return [r for r in (session.process(next(it)) for _ in range(n))
            if r is not None]


class TestTrigCapture:
    def test_t_key_writes_trig_set(self, cfg, src, tmp_path):
        sink = RunWriter(tmp_path, "sj")
        s = Session(cfg, variant="spinj", sink=sink)
        s.key("t")
        feed(s, src, 4)
        names = sorted(p.name for p in sink.dir.glob("Trig*.png"))
        assert names == ["Trig000-000.png", "Trig000-001.png",
                         "Trig000-002.png"]
        # 16-bit Mono16 conversion
        from fdoct_tpu.utils.imageio import read_png
        assert read_png(sink.dir / "Trig000-000.png").dtype == np.uint16

    def test_k_key_writes_ktrig(self, cfg, src, tmp_path):
        sink = RunWriter(tmp_path, "sj2")
        s = Session(cfg, variant="spinj", sink=sink)
        s.key("k")
        feed(s, src, 3)
        assert (sink.dir / "KTrig000-000.png").exists()

    def test_alternating_capture(self, cfg, src, tmp_path):
        sink = RunWriter(tmp_path, "sj3")
        s = Session(cfg, variant="spinj", sink=sink)
        s.key("|")
        feed(s, src, 6)
        names = {p.name for p in sink.dir.glob("*Trig*.png")}
        assert "Trig000-000.png" in names and "KTrig000-000.png" in names
        assert "Trig000-002.png" in names  # 3 signal + 3 J0

    def test_set_counter_increments(self, cfg, src, tmp_path):
        sink = RunWriter(tmp_path, "sj4")
        s = Session(cfg, variant="spinj", sink=sink)
        s.key("t")
        feed(s, src, 3)
        s.key("t")
        feed(s, src, 3)
        assert (sink.dir / "Trig001-000.png").exists()


class TestOcvDumps:
    def test_spectrum_and_bscandb_ocv(self, cfg, src, tmp_path):
        from fdoct_tpu.utils.ocv_io import matread
        sink = RunWriter(tmp_path, "ocv")
        s = Session(cfg, variant="spinj", sink=sink)
        s.key("b")
        feed(s, src, 2)                 # background capture completes
        assert (sink.dir / "spectrum.ocv").exists()
        spec = matread(sink.dir / "spectrum.ocv")
        assert np.allclose(spec, np.asarray(s.data_yb))
        s.key("s")
        feed(s, src, 2)
        assert (sink.dir / "bscandb001.ocv").exists()


class TestAveragesKeys:
    def test_increment_decrement(self, cfg):
        s = Session(cfg, variant="spinj")
        s.key("3"); s.key("3"); s.key("#")
        assert s.averagestoggle == cfg.averages + 12
        s.key("4"); s.key("$")
        assert s.averagestoggle == max(cfg.averages + 11 - 10, 1)
        for _ in range(10):
            s.key("$")
        assert s.averagestoggle == 1


class TestOfflineHandoff:
    def test_y_key_spawns_tool(self, cfg, src, tmp_path, monkeypatch):
        sink = RunWriter(tmp_path, "sj5")
        calls = {}

        class FakeProc:
            def __init__(self, cmd):
                calls["cmd"] = cmd

        monkeypatch.setattr("subprocess.Popen", lambda cmd: FakeProc(cmd))
        s = Session(cfg.replace(offline_tool_path="/opt/tool"),
                    variant="spinj", sink=sink)
        s.key("y")
        # the reference's argv protocol: {tool, dirname, manualaverages}
        assert calls["cmd"] == ["/opt/tool", str(sink.dir), "3"]

    def test_y_key_without_tool_reconstructs_in_process(self, cfg, src,
                                                        tmp_path,
                                                        monkeypatch):
        """No external tool configured: the offline reconstruction runs on
        a worker thread of the live process (a second JAX process would
        compete for the accelerator's memory), never as a child."""
        def no_child(*a, **k):
            raise AssertionError("offline hand-off started a process")

        monkeypatch.setattr("subprocess.Popen", no_child)
        sink = RunWriter(tmp_path, "sj6")
        s = Session(cfg, variant="spinj", sink=sink)
        s.key("t")
        feed(s, src, 3)                  # one Trig set of manualaverages=3
        s.key("y")
        s.close()                        # joins the hand-off
        assert (sink.dir / "offline_bscan000.png").exists()
        assert (sink.dir / "offline_bscanc000.png").exists()
        assert any("1 sets" in m for m in s.status), s.status


class TestBscanRebin:
    def test_rebin_changes_output_but_keeps_shape(self, src):
        base = PipelineConfig(width=64, height=8, averages=1,
                              numfftpoints=128, numdisplaypoints=40,
                              dtype="float64")
        sA = Session(base)
        sB = Session(base.replace(bscanbinx=2, bscanbiny=2))
        it = iter(src.frames())
        f = next(it)
        rA = sA.process(f)
        rB = sB.process(f)
        assert rA.bscan.shape == rB.bscan.shape
        assert not np.allclose(rA.bscan, rB.bscan)
