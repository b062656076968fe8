"""Preemption of the port's ``train()``: a child process (which imports no
JAX) gets SIGTERM once its metrics file shows step 10; it ends the current
chunk, checkpoints and exits cleanly, and a resumed run equals an
uninterrupted one bit for bit. A second signal kills the process with the
default disposition."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from molvax_torch.io import checkpoint as ckpt
from test_torch_train_loop import _assert_payloads_equal, _payload

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys, time
from molvax_torch import config as C
from molvax_torch.data import synthetic_dataset
from molvax_torch.train import loop

mode, ckdir, metrics, max_steps = sys.argv[1:5]
model = C.ModelConfig(max_len=32, latent_dim=8, conv_kernels=(5, 5, 5), enc_hidden=16, gru_hidden=12, gru_layers=2,
                      learned_start=True, compute_dtype="bfloat16", use_pallas=True)
train = C.TrainConfig(batch_size=8, train_chunk_size=2 if mode == "fast" else 1, log_every=1, checkpoint_every=1000,
                      checkpoint_dir=ckdir, learning_rate=1e-2, ema_decay=0.9)
if mode == "slow":  # each step long enough for two signals to land inside it
    real = loop.make_train_step

    def slow(cfg, mesh=None):
        step = real(cfg, mesh)

        def run(*args):
            time.sleep(0.5)
            return step(*args)

        return run

    loop.make_train_step = slow
state, hist = loop.train(C.Config(model=model, train=train, data=C.DataConfig(max_len=32)),
                         synthetic_dataset(200, max_len=32, seed=0), device="cpu", metrics_path=metrics,
                         max_steps=int(max_steps), verbose=False)
jax = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "molvax.")) or m == "molvax")
print(json.dumps({"step": state.step, "jax": jax}))
"""


def _child(mode: str, ckdir, metrics, max_steps: int) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.Popen([sys.executable, "-c", CHILD, mode, str(ckdir), str(metrics), str(max_steps)], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait_for_step(proc: subprocess.Popen, metrics: Path, step: int, timeout: float = 120.0) -> int:
    """Polls the metrics file until a row has ``step`` or more; returns it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate()
        if metrics.exists():
            steps = [json.loads(line)["step"] for line in metrics.read_text().splitlines() if line.endswith("}")]
            if steps and max(steps) >= step:
                return max(steps)
        time.sleep(0.02)
    proc.kill()
    raise AssertionError(f"the child logged no step {step} within {timeout} s")


def _finish(proc: subprocess.Popen, timeout: float = 120.0) -> dict:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["jax"] == [], result
    return result


def _rows(metrics: Path, after: int):
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in rows if r["step"] > after]


def test_sigterm_checkpoints_and_the_resume_equals_an_uninterrupted_run(tmp_path):
    stopped = _child("fast", tmp_path / "A", tmp_path / "a.jsonl", 100_000)
    _wait_for_step(stopped, tmp_path / "a.jsonl", 10)
    stopped.send_signal(signal.SIGTERM)
    at = _finish(stopped)["step"]
    assert 10 <= at < 100_000 and at % 2 == 0  # the chunk of 2 it was in ended first
    assert ckpt.make_manager(str(tmp_path / "A")).latest_step() == at
    target = at + 12
    resumed = _child("fast", tmp_path / "A", tmp_path / "b.jsonl", target)
    straight = _child("fast", tmp_path / "C", tmp_path / "c.jsonl", target)
    assert _finish(resumed)["step"] == _finish(straight)["step"] == target
    _assert_payloads_equal(_payload(tmp_path / "A", target), _payload(tmp_path / "C", target))
    assert _rows(tmp_path / "b.jsonl", at) == _rows(tmp_path / "c.jsonl", at)
    assert len(_rows(tmp_path / "b.jsonl", at)) == 12


def test_a_second_signal_kills_the_process(tmp_path):
    proc = _child("slow", tmp_path / "A", tmp_path / "a.jsonl", 100_000)
    _wait_for_step(proc, tmp_path / "a.jsonl", 2)
    proc.send_signal(signal.SIGTERM)
    time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    proc.communicate(timeout=60)
    assert proc.returncode == -signal.SIGTERM
    assert ckpt.make_manager(str(tmp_path / "A")).latest_step() is None  # killed before it could checkpoint
