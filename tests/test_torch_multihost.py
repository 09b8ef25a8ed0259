"""The port's multi-process campaign and dry run, on the CPU.

Two OS processes join one gloo process group through
``polar_tpu_torch.parallel.multihost`` (as ``tests/test_multiprocess.py``
runs JAX's), each with a mesh of 4 positions on the CPU: both must print
the same all-reduced points, and a second run with the lead's checkpoint
must skip every point through the broadcast. Then the single-process
no-op, the CLI's ``main`` and ``dryrun_multichip(8, "cpu")``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

import polar_tpu_torch as pt
from polar_tpu_torch.parallel import multihost
from polar_tpu_torch.parallel.dryrun import dryrun_multichip
from polar_tpu_torch.parallel.mesh import frame_mesh

REPO = Path(__file__).resolve().parent.parent


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(pid, port, ckpt):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(key, None)
    args = [sys.executable, "-m", "polar_tpu_torch.parallel.multihost",
            "--m", "5", "--per-device-batch", "32",
            "--max-global-frames", "1024", "--target-errors", "50",
            "--snr-min", "0.0", "--snr-max", "2.0", "--snr-step", "1.0",
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(pid), "--device", "cpu", "--positions", "4"]
    if ckpt is not None:
        args += ["--checkpoint", str(ckpt)]
    return subprocess.Popen(args, cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _run_pair_once(port, ckpt):
    procs = [_spawn(i, port, ckpt) for i in range(2)]
    results, errors = [], []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode != 0:
            errors.append(f"worker rc={proc.returncode}\n--- stdout\n"
                          f"{stdout}\n--- stderr\n{stderr[-4000:]}")
            continue
        results.append(json.loads(stdout.strip().splitlines()[-1]))
    return results, errors


def _run_pair(ckpt=None):
    """The 2-process pair; one retry on a fresh port (the port found free
    can be taken before the lead binds it)."""
    results, errors = _run_pair_once(_free_port(), ckpt)
    if not errors:
        return results
    results2, errors2 = _run_pair_once(_free_port(), ckpt)
    assert not errors2, ("2-process pair failed twice\n=== attempt 1\n"
                         + "\n".join(errors)
                         + "\n=== attempt 2\n" + "\n".join(errors2))
    return results2


def test_torch_two_process_campaign_agrees():
    a, b = _run_pair()
    assert (a["process"], b["process"]) == (0, 1)
    assert a["points"] == b["points"]
    assert len(a["points"]) >= 3
    # 2 processes x 4 positions x 32 frames a step
    assert all(p["frames"] % (8 * 32) == 0 and p["frames"] > 0
               for p in a["points"])
    assert a["points"][0]["bit_errors"] > 0


def test_torch_two_process_checkpoint_resume(tmp_path):
    """Only the lead writes the checkpoint; a second pair skips every point
    through its broadcast and prints the same points."""
    ckpt = tmp_path / "ckpt.json"
    first = _run_pair(ckpt)
    saved = json.loads(ckpt.read_text())
    assert saved["points"] and saved["code_n"] == 32
    assert first[0]["points"] == first[1]["points"]
    second = _run_pair(ckpt)
    assert [r["points"] for r in second] == [first[0]["points"]] * 2


def test_torch_initialize_noop_without_coordinator(monkeypatch):
    for key in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.initialize_multihost() is False
    assert multihost.is_lead_host()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    with pytest.raises(ValueError):
        multihost.initialize_multihost("127.0.0.1:1")


def test_torch_multihost_campaign_single_process(tmp_path):
    code = pt.make_code(6, rate=0.5)
    ckpt = tmp_path / "ckpt.json"
    kw = dict(per_device_batch=32, max_global_frames=512,
              target_bit_errors=50, snr_range=(4.0, 10.0), snr_step=1.0,
              stop_after_clean=2, verbose=False,
              mesh=frame_mesh(["cpu"] * 8), checkpoint_path=ckpt)
    points = multihost.run_multihost_campaign(code, **kw)
    assert len(points) >= 2
    assert points[-1]["bit_errors"] == 0
    assert points[0]["frames"] % (32 * 8) == 0
    assert multihost.run_multihost_campaign(code, **kw) == points


def test_torch_multihost_cli_main(tmp_path, capsys):
    out = tmp_path / "pod.json"
    assert multihost.main([
        "--m", "5", "--per-device-batch", "16", "--out", str(out),
        "--max-global-frames", "256", "--target-errors", "50",
        "--snr-min", "4", "--snr-max", "8", "--snr-step", "2",
        "--device", "cpu", "--positions", "8"]) == 0
    data = json.loads(out.read_text())
    assert data["code_n"] == 32
    assert len(data["points"]) >= 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"process": 0, "points": data["points"]}


def test_torch_dryrun_multichip_on_cpu():
    out = dryrun_multichip(8, "cpu")
    assert out["fps"] > 0
    assert out["sharded"]["uncorrected_errors"] > 0
