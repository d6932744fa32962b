"""``chip_smoke.py``: its phases at tiny sizes on explicit CPU devices, its
refusal to run without a GPU, and (marked ``gpu``) the script itself on a
card."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def test_phase_flow_tiny(cpu):
    r = chip_smoke.phase_flow(N=31, steps=5, timed_steps=2, reps=2,
                              device=cpu)
    assert r["ok"] and r["value"] < 1.0
    assert r["mlups"] > 0 and r["kernels_per_step"] > 0
    assert r["gbps_72"] == pytest.approx(r["mlups"] * 72e-3)


def test_phase_poiseuille_tiny(cpu):
    r = chip_smoke.phase_poiseuille(N=10, device=cpu)
    assert r["ok"] and r["limit"] == pytest.approx(0.05 * 0.5625)


def test_phase_config5_tiny(cpu):
    rs = chip_smoke.phase_config5(size=32, steps=2, timed_steps=2, reps=2,
                                  ref_size=16, ref_steps=3, device=cpu,
                                  ref_device=cpu)
    assert [r["ok"] for r in rs] == [True, True]
    assert rs[0]["value"] < 1e-5 and rs[1]["value"] == 0.0


def test_four_phases_tiny():
    """The --four comparisons on four virtual CPU devices."""
    devices = jax.devices()[:4]
    assert len(devices) == 4
    results = (chip_smoke.four_pipe(size=64, steps=3, devices=devices)
               + chip_smoke.four_config5(size=64, steps=3, devices=devices))
    assert all(r["ok"] for r in results), results


def test_loop_body_kernels_counts_while_body():
    hlo = """HloModule m

%fused_a (p: f32[4]) -> f32[4] {
  %p = f32[4]{0} parameter(0)
  ROOT %n = f32[4]{0} negate(%p)
}

%body (t: (s32[], f32[4])) -> (s32[], f32[4]) {
  %t = (s32[], f32[4]{0}) parameter(0)
  %x = f32[4]{0} get-tuple-element(%t), index=1
  %f1 = f32[4]{0} fusion(%x), kind=kLoop, calls=%fused_a
  %c = f32[4]{0} custom-call(%f1), custom_call_target="x"
  ROOT %r = (s32[], f32[4]{0}) tuple(%i, %c)
}

ENTRY %main (a: f32[4]) -> f32[4] {
  %w = (s32[], f32[4]{0}) while(%init), condition=%cond, body=%body
  %f9 = f32[4]{0} fusion(%a), kind=kLoop, calls=%fused_a
}
"""
    assert chip_smoke.loop_body_kernels(hlo) == 2


def test_main_refuses_cpu(capsys):
    """No GPU: non-zero exit, the platform named, no result line."""
    assert chip_smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert "'cpu'" in err
    assert '"ok"' not in out


@pytest.fixture
def card():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this host")


@pytest.mark.gpu
def test_chip_smoke_on_card(card):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith('{"ok": true, "device": {"platform": "gpu"')
