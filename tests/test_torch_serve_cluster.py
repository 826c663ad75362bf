"""The serving launcher (repro_torch.launch.serve_cluster) on the CPU.

The launcher runs in-process with --device cpu --smoke at its smoke size
(n = 2,000, as the JAX launcher's) for each flag and each --bench choice;
each run prints `serve_cluster: OK` and writes exactly the sections the
JAX package's run_benches writes for its modes (plus the port's
`device`; tests/test_torch_serve_bench.py holds the keys against JAX's).
Worlds of gloo ranks run the launcher as one process a rank: --sharded
--bench sync over 2 ranks, every mode (--bench all --swap --stream
--fleet) over 2 and the async bench, through the rank-0 pump, over 4.
Such worlds start through tests/torch_worlds.py's run_env_world.
"""
import json

import pytest
import torch

from repro_torch.launch import serve_cluster
from torch_worlds import run_env_world as run_world

SMALL = ["--device", "cpu", "--smoke", "--queries", "128", "--repeats", "1",
         "--bench-passes", "1", "--batch-sizes", "8,64",
         "--async-requests", "32"]
# The sections the JAX package's run_benches writes: always BASE, then
# each mode's own (src/repro/serve/bench.py run_benches).
BASE = {"model", "backend", "calibration", "sharded"}
MODE_SECTIONS = {"sync": {"batch_sizes", "results", "bucket_executables"},
                 "async": {"async"}, "fused": {"fused"}, "swap": {"swap"},
                 "backends": {"backends"}, "stream": {"stream"},
                 "fit_scaling": {"fit_scaling"}, "fleet": {"fleet"}}
PORT_ONLY = {"device"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread for each test: the suite runs several test
    processes on the machine's cores, where more threads per process
    only contend (an n = 2,000 eigh slowed 80-fold so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sections(modes):
    out = set(BASE)
    for m in modes:
        out |= MODE_SECTIONS[m]
    return out


def _launch(tmp_path, capsys, *extra):
    bench_out = tmp_path / "bench.json"
    rc = serve_cluster.main(SMALL + list(extra) + [
        "--artifact-dir", str(tmp_path / "art" / "demo"),
        "--bench-out", str(bench_out)])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.strip().splitlines()[-1] == "serve_cluster: OK"
    return json.loads(bench_out.read_text()), out


RUNS = {
    "default": ([], tuple(MODE_SECTIONS)),
    "swap-gc-keep-2": (["--swap", "--gc-keep", "2", "--bench", "sync"],
                       ("sync",)),
    "stream": (["--stream", "--bench", "sync"], ("sync",)),
    "fleet": (["--fleet", "--fleet-workers", "2", "--bench", "fleet"],
              ("fleet",)),
    "nystrom": (["--backend", "nystrom", "--bench", "sync"], ("sync",)),
    "exact": (["--backend", "exact", "--bench", "sync"], ("sync",)),
    "onepass-gaussian": (["--backend", "onepass-gaussian", "--bench",
                          "sync"], ("sync",)),
    "rbf": (["--kernel", "rbf", "--bench", "sync"], ("sync",)),
    # "default" is --bench all.
    **{f"bench-{m}": (["--bench", m], (m,)) for m in MODE_SECTIONS},
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_launcher_runs_on_the_cpu(tmp_path, capsys, name):
    extra, modes = RUNS[name]
    bench, out = _launch(tmp_path, capsys, *extra)
    assert set(bench) == _sections(modes) | PORT_ONLY
    assert bench["backend"] == "cpu" and bench["sharded"] is False
    assert bench["calibration"]["matmul512_ms"] > 0
    if "backends" in modes:
        assert set(bench["backends"]["per_backend"]) == {
            "exact", "nystrom", "onepass-gaussian", "onepass-srht"}
    if "--swap" in extra:
        assert "warm swap" in out and "published v1, v2, v3 -> [2, 3]" \
            in out
    if "--stream" in extra:
        assert "stream: drift" in out
    if "--fleet" in extra:
        assert "breached canary rolled back" in out
    if name == "rbf":
        assert "not gated" in out
    backend = extra[extra.index("--backend") + 1] if "--backend" in extra \
        else "onepass-srht"
    assert ("sharded fit (1 shard) bit-identical" in out) == \
        backend.startswith("onepass-")


def test_the_card_is_the_default(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        serve_cluster.main(["--smoke"])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err


def test_interpret_is_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit) as e:
        serve_cluster.main(["--smoke", "--interpret"])
    assert e.value.code != 0
    assert "plain versions" in capsys.readouterr().err


def test_interpret_takes_the_kernel_paths_on_the_cpu(tmp_path, capsys):
    bench, _ = _launch(tmp_path, capsys, "--interpret", "--bench", "fused")
    assert bench["fused"]["interpret"] is True


# -- worlds of 2 gloo ranks ---------------------------------------------------

LAUNCHER = ["-m", "repro_torch.launch.serve_cluster"] + SMALL


def test_sharded_sync_over_two_ranks(tmp_path):
    res = run_world(LAUNCHER + ["--sharded", "--bench", "sync"], 2, tmp_path)
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
    out = res[0][1]
    assert out.strip().splitlines()[-1] == "serve_cluster: OK"
    assert "sharded fit (2 shards) within 2e-3" in out
    assert "sharded extension matches single-device over 2" in out
    bench = json.loads((tmp_path / "BENCH_serve_torch.json").read_text())
    assert bench["sharded"] == {"shards": 2, "axis": "data"}
    assert set(bench) == _sections(("sync",)) | PORT_ONLY


def test_sharded_every_mode_over_two_ranks(tmp_path):
    """--sharded --bench all --swap --stream --fleet: the async bench
    through the rank-0 pump, the lifecycle checks and sections on rank 0
    alone; every rank exits 0 and rank 0's bench file has every section
    and the mesh."""
    res = run_world(LAUNCHER + ["--sharded", "--bench", "all", "--swap",
                                "--stream", "--fleet"], 2, tmp_path)
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
    out = res[0][1]
    assert out.strip().splitlines()[-1] == "serve_cluster: OK"
    for line in ("warm swap", "stream: drift", "breached canary rolled back",
                 "sharded extension matches single-device over 2"):
        assert line in out, line
    bench = json.loads((tmp_path / "BENCH_serve_torch.json").read_text())
    assert bench["sharded"] == {"shards": 2, "axis": "data"}
    assert set(bench) == _sections(tuple(MODE_SECTIONS)) | PORT_ONLY
    assert bench["async"]["n_requests"] == 32
    assert bench["swap"]["stranded_futures"] == 0


def test_sharded_async_over_four_ranks(tmp_path):
    res = run_world(LAUNCHER + ["--sharded", "--bench", "async"], 4,
                    tmp_path)
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
    assert res[0][1].strip().splitlines()[-1] == "serve_cluster: OK"
    bench = json.loads((tmp_path / "BENCH_serve_torch.json").read_text())
    assert bench["sharded"] == {"shards": 4, "axis": "data"}
    assert set(bench) == _sections(("async",)) | PORT_ONLY
    assert bench["async"]["latency"]["requests"] == 32
