"""Multi-host integration: 2 processes x 4 virtual CPU devices.

The round-1 review's top distributed gap: the engine had meshes and
collectives but no ``jax.distributed`` bring-up.  These tests spawn real
separate processes (Gloo collectives over TCP — the DCN stand-in), assemble
per-host table slices into global arrays, and check the shuffle join's count
oracles end-to-end.
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_NUM_CPU_DEVICES", None)
    if extra_env:
        env.update(extra_env)
    return subprocess.Popen(
        [sys.executable] + args,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        env=env,
        cwd=REPO,
    )


def test_two_process_shuffle_join_oracles():
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        _spawn([os.path.join(REPO, "tests", "mp_worker.py"), coord, "2", str(i)])
        for i in range(2)
    ]
    outs = [p.communicate(timeout=560)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MP_OK pid={i}" in out, out


def test_two_process_cli_renders_on_process_zero(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    outfile = tmp_path / "mp_result.json"
    base = [
        "-m", "partitionedhashjoin_tpu",
        "--coordinator", coord, "--num-processes", "2",
        "--platform", "cpu", "--join", "shuffle",
        "--primary", "1024", "--secondary", "4096", "--seed", "9",
        "--log", "error", "--no-warmup",
    ]
    p0 = _spawn(base + ["--process-id", "0",
                        "--output", "file", "--filename", str(outfile)])
    p1 = _spawn(base + ["--process-id", "1",
                        "--output", "stdout"])  # non-zero process: no render
    out0 = p0.communicate(timeout=560)[0]
    out1 = p1.communicate(timeout=560)[0]
    assert p0.returncode == 0, out0
    assert p1.returncode == 0, out1
    doc = json.loads(outfile.read_text())
    assert doc["parameters"]["Type"] == "DistributedShuffle"
    assert doc["parameters"]["NumberOfShards"] == "8"
    assert doc["parameters"]["NumberOfProcesses"] == "2"
    assert set(doc["results"]) == {"partition", "build", "probe"}
    # the single-writer convention: process 1 emitted no JSON document
    assert "hashjointimingresult" not in out1
