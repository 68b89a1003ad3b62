"""The port's fleet CLI (``repro_torch.launch.fleet``) against the
reference's (``repro.launch.fleet``).

``--dryrun`` prints the placement plans of every preset; its text must be
identical to the reference CLI's, character for character, at the
defaults and at two other fleet shapes.  The serve mode runs in process
on the CPU on reduced gemma3-4b: with drains, a respawn and explicit
``--chaos-events`` it exits 0 with every request finished; ``--max-ticks
2`` exits 1 with the reference's ``FATAL`` line; an architecture the
pool cannot serve exits with the reference's message; ``--obs-out``
writes the reference's ``fleet_serve`` artifact, which the port's
``launch/report.py`` renders with the fleet's counters.
"""

import json

import pytest

from repro.launch import fleet as jcli
from repro_torch.launch import fleet as tcli
from repro_torch.launch import report
from torch_threads import pin_threads  # noqa: F401

SERVE = ["--arch", "gemma3-4b", "--reduced", "--device", "cpu",
         "--replicas", "3", "--slots", "2", "--requests", "8",
         "--rate", "1.0", "--max-new", "4", "--prompt-len-max", "24",
         "--sessions", "3", "--seed", "3"]


@pytest.mark.parametrize("argv", [
    [], ["--ranks", "16", "--replicas", "4", "--tp", "4"],
    ["--ranks", "8", "--replicas", "8", "--tp", "1", "--slots", "16",
     "--arch", "phi4-mini-3.8b"]], ids=["defaults", "16x4x4", "8x8x1"])
def test_dryrun_text_matches_jax(capsys, argv):
    tcli.main(["--dryrun", "--topology", "all"] + argv)
    got = capsys.readouterr().out
    jcli.main(["--dryrun", "--topology", "all"] + argv)
    exp = capsys.readouterr().out
    assert got == exp
    assert got.count("<== chosen") == 5


def test_serve_with_drain_respawn_and_chaos(capsys, tmp_path, monkeypatch):
    """Drains, a respawn and a crash under the supervisor: exit 0, every
    request finished, the crash recovered; the feedback file saved."""
    monkeypatch.setenv("REPRO_FLEET_FEEDBACK_DIR", str(tmp_path))
    tcli.main(SERVE + ["--drain", "2:1", "--respawn", "6:1", "--drain",
                       "4:2", "--chaos-events", "1:crash:0",
                       "--chaos-events", "3:straggler:2:4",
                       "--device-kind", "cpu", "--save-feedback",
                       "--timestamp", "t0"])
    out = capsys.readouterr().out
    assert "[fleet] finished 8/8" in out
    assert "[fleet] chaos: 1:crash:0:1 3:straggler:2:4" in out
    assert "[fleet] resilience: 1 crashes" in out
    assert "[fleet] events: drain@2->r1, drain@4->r2, respawn@6->r1" in out
    assert "[fleet] kernel launches: {}" in out     # plain versions on CPU
    assert (tmp_path / "cpu__tpu_multipod__p3.json").is_file()


def test_max_ticks_exits_1_with_fatal(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(SERVE + ["--max-ticks", "2"])
    assert e.value.code == 1
    err = capsys.readouterr().err
    assert "[fleet] FATAL: serve loop died" in err
    assert "max_ticks=2" in err


def test_pool_unsupported_arch_exits(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu"])
    assert str(e.value) == ("[fleet] zamba2-2.7b: pool unsupported (see "
                            "engine.pool_supported) — the fleet needs the "
                            "paged-KV scheduler")


def test_obs_artifact_renders_in_report(capsys, tmp_path):
    """``--obs-out``: the reference's artifact keys, ``kind`` fleet_serve,
    and the report's counters section lists the fleet's drains, crashes,
    respawns and chaos events."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import timeline as obs_timeline
    obs_metrics.get_registry().reset()
    obs_timeline.get_timeline().clear()
    path = tmp_path / "fleet.json"
    tcli.main(SERVE + ["--mesh", "1,2", "--drain", "3:1", "--respawn",
                       "5:1", "--chaos-events", "1:crash:0",
                       "--obs-out", str(path), "--timestamp", "t0"])
    capsys.readouterr()
    art = json.loads(path.read_text())
    assert sorted(art) == ["chrome_trace", "config", "format", "kind",
                           "registry", "stats", "timeline", "timestamp"]
    assert art["kind"] == "fleet_serve" and art["format"] == 1
    assert art["stats"]["resilience"]["crashes"][0]["replica"] == 0
    assert report.main(["--artifact", str(path)]) == 0
    out = capsys.readouterr().out
    for counter in ("fleet_drains", "fleet_respawns", "fleet_crashes",
                    "chaos_events", "serve_requests_retired"):
        assert f"[report]   {counter}" in out, counter
    assert "fleet_tick_seconds" in out
