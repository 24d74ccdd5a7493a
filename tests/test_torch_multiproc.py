"""The port's process-group setup and local spawner
(``apex_tpu_torch.parallel.multiproc``), as ``tests/distributed/
test_multiproc.py`` holds the JAX package's: ``initialize`` reads JAX's
environment contract (and torchrun's address), bounds cluster formation
by timeout, retries and backoff and names the missing ranks, fails fast
when already initialized, and never swaps the backend; ``spawn`` reports
a dying rank's stderr and reaps a peer wedged after its partner left
(short grace times); and a real 2-rank gloo run through ``python -m
apex_tpu_torch.parallel.multiproc``, with rank 0 on stdout and rank 1
in ``PROC_1.log``.
"""

import datetime
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import multiproc

ROOT = str(pathlib.Path(__file__).resolve().parents[1])


class _Boom(RuntimeError):
    pass


@pytest.fixture
def no_env(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK", "LOCAL_RANK", "APEX_TPU_INIT_TIMEOUT_S",
              "APEX_TPU_INIT_RETRIES", "APEX_TPU_INIT_BACKOFF_S"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _capture(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    return calls


def test_initialize_reads_jaxs_environment(no_env):
    calls = _capture(no_env)
    no_env.setenv("COORDINATOR_ADDRESS", "10.0.0.7:1234")
    no_env.setenv("WORLD_SIZE", "4")
    no_env.setenv("RANK", "2")
    no_env.setenv("APEX_TPU_INIT_TIMEOUT_S", "7")
    multiproc.initialize(device="cpu")
    (args, kw), = calls
    assert args == ("gloo",)
    assert kw["init_method"] == "tcp://10.0.0.7:1234"
    assert (kw["world_size"], kw["rank"]) == (4, 2)
    assert kw["timeout"] == datetime.timedelta(seconds=7)


def test_initialize_falls_back_to_torchruns_address(no_env):
    calls = _capture(no_env)
    no_env.setenv("MASTER_ADDR", "localhost")
    no_env.setenv("MASTER_PORT", "29500")
    multiproc.initialize(num_processes=2, process_id=1, device="cpu",
                         backend="gloo")
    assert calls[0][1]["init_method"] == "tcp://localhost:29500"
    assert (calls[0][1]["world_size"], calls[0][1]["rank"]) == (2, 1)


def test_initialize_refuses_a_missing_world_or_a_swapped_backend(no_env):
    calls = _capture(no_env)
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        multiproc.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="RANK"):
        multiproc.initialize("localhost:1", num_processes=2, device="cpu")
    if not torch.cuda.is_available():
        # nccl, the default, wants the card: no silent switch to gloo
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multiproc.initialize("localhost:1", 2, 0)
    assert calls == []


def test_initialize_runs_the_preflight_after_formation(no_env):
    """``initialize(preflight=...)`` forms the group, then captures the
    callable dry and returns the preflight's record (the group here is
    the monkeypatched one, so the barrier sees one rank)."""
    from apex_tpu_torch.analysis.spmd import schedule_fingerprint
    calls = _capture(no_env)
    seen = []

    def step():
        seen.append(len(calls))
        return torch.ones(2) * 2

    rec = multiproc.initialize("localhost:1", 2, 0, device="cpu",
                               preflight=step, preflight_label="unit")
    assert len(calls) == 1 and seen == [1]
    assert rec["label"] == "unit" and rec["ok"]
    assert (rec["n_collectives"], rec["exchange"]) == (0, "none")
    assert rec["schedule_hash"] == schedule_fingerprint([])
    assert multiproc.initialize("localhost:1", 2, 0, device="cpu") is None
    with pytest.raises(TypeError, match="Capture"):
        multiproc.initialize("localhost:1", 2, 0, device="cpu",
                             preflight="module")


def test_initialize_retries_with_backoff_then_names_missing_ranks(no_env):
    calls = {"n": 0}
    sleeps = []

    def never_forms(backend, init_method=None, world_size=None, rank=None,
                    timeout=None):
        calls["n"] += 1
        assert timeout == datetime.timedelta(seconds=1)
        raise _Boom("barrier timed out")

    no_env.setattr(dist, "init_process_group", never_forms)
    no_env.setattr(multiproc.time, "sleep", sleeps.append)
    with pytest.raises(multiproc.ClusterInitError) as ei:
        multiproc.initialize(coordinator_address="localhost:1",
                             num_processes=4, process_id=1,
                             timeout_s=1.0, retries=2, backoff_s=0.5,
                             device="cpu")
    msg = str(ei.value)
    assert "rank 1 of 4" in msg
    assert "[0, 2, 3]" in msg
    assert "3 attempt(s)" in msg
    assert calls["n"] == 3
    assert sleeps == [0.5, 1.0]


def test_initialize_env_tunable_and_succeeds_mid_retry(no_env):
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("peer not yet up")

    no_env.setattr(dist, "init_process_group", flaky)
    no_env.setattr(multiproc.time, "sleep", lambda s: None)
    no_env.setenv("APEX_TPU_INIT_RETRIES", "5")
    no_env.setenv("APEX_TPU_INIT_BACKOFF_S", "0.01")
    multiproc.initialize("localhost:1", 2, 0, device="cpu")
    assert calls["n"] == 3


def test_initialize_already_initialized_fails_fast(no_env):
    calls = {"n": 0}

    def double(*a, **kw):
        calls["n"] += 1
        raise ValueError("trying to initialize the default process group "
                         "twice!")

    no_env.setattr(dist, "init_process_group", double)
    no_env.setattr(multiproc.time, "sleep",
                   lambda s: pytest.fail("must not back off"))
    with pytest.raises(ValueError, match="twice"):
        multiproc.initialize("localhost:1", 2, 0, timeout_s=1.0, retries=5,
                             backoff_s=9.0, device="cpu")
    assert calls["n"] == 1
    no_env.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="already initialized"):
        multiproc.initialize("localhost:1", 2, 0, device="cpu")
    assert calls["n"] == 1


def test_spawn_reports_a_dying_ranks_stderr(tmp_path, monkeypatch):
    script = tmp_path / "die.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        if os.environ["RANK"] == "1":
            sys.exit("rank one gives up")
        time.sleep(300)
    """))
    monkeypatch.chdir(tmp_path)
    t0 = time.monotonic()
    with pytest.raises(multiproc.ClusterInitError) as ei:
        multiproc.spawn([str(script)], world_size=2)
    assert time.monotonic() - t0 < 60
    msg = str(ei.value)
    assert "rank 1 exited with code 1" in msg
    assert "rank one gives up" in msg


def test_spawn_reaps_zombie_peer_after_grace(tmp_path, monkeypatch):
    script = tmp_path / "wedge.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        if os.environ["RANK"] == "0":
            sys.exit(0)
        time.sleep(300)
    """))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("APEX_TPU_SPAWN_GRACE_S", "2")
    t0 = time.monotonic()
    with pytest.raises(multiproc.ClusterInitError) as ei:
        multiproc.spawn([str(script)], world_size=2)
    assert time.monotonic() - t0 < 60
    msg = str(ei.value)
    assert "ranks [1]" in msg
    assert "wedged" in msg
    assert "rank 0 exited cleanly" in msg


WORKER = textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch.parallel import multiproc
    multiproc.initialize(device="cpu")   # COORDINATOR_ADDRESS, WORLD_SIZE, RANK
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    print("RANK", dist.get_rank(), "SUM", float(x[0]), flush=True)
    dist.destroy_process_group()
""")


def test_spawn_two_process_all_reduce(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, WORLD_SIZE="2", APEX_TPU_INIT_TIMEOUT_S="60",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         str(script)], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "RANK 0 SUM 3.0" in out.stdout, out.stdout
    assert "RANK 1 SUM 3.0" in (tmp_path / "PROC_1.log").read_text()


def test_main_needs_a_script(capsys):
    assert multiproc.main([]) == 2
    assert "usage" in capsys.readouterr().err
