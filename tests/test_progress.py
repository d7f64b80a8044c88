"""Live-progress surface (the reference's in-training Streamlit bars and
loss/AUC line charts, `gnn.py:160-196` / `TwoWL_work.py:119-129`, as a
CLI-native in-place line — SURVEY §5 metrics/observability row)."""

import io

from linkpred.utils.progress import LiveProgress, sparkline


class TestSparkline:
    def test_monotone_series_renders_ramp(self):
        s = sparkline([1, 2, 3, 4, 5, 6, 7, 8])
        assert s[0] == "▁" and s[-1] == "█" and len(s) == 8

    def test_sentinels_and_nans_dropped(self):
        assert sparkline([-1.0, float("nan"), 2.0, 4.0]) == sparkline(
            [2.0, 4.0])

    def test_constant_series_safe(self):
        assert sparkline([3.0, 3.0, 3.0]) == "▁▁▁"

    def test_empty(self):
        assert sparkline([]) == ""


class TestLiveProgress:
    def test_non_tty_prints_deciles_only(self):
        buf = io.StringIO()  # StringIO.isatty() -> False
        p = LiveProgress(100, label="t", stream=buf)
        for i in range(1, 101):
            p.update(i, loss=1.0 / i)
        p.close()
        lines = [ln for ln in buf.getvalue().splitlines() if ln]
        # one line per decile crossing, not one per update
        assert 5 <= len(lines) <= 12, lines
        assert "100/100" in lines[-1]
        assert "loss" in lines[-1]

    def test_final_line_has_bar_and_sparklines(self):
        buf = io.StringIO()
        p = LiveProgress(10, label="x", stream=buf)
        for i in range(1, 11):
            p.update(i, loss=10.0 - i, auc=i / 10.0)
        out = buf.getvalue().splitlines()[-1]
        assert "[" in out and "]" in out
        assert "val 1.0000" in out
        assert any(c in out for c in "▁▂▃▄▅▆▇█")
