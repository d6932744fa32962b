"""Smoke test of lb2d_tpu's main path on NVIDIA cards.

    python chip_smoke.py           # one card: phases (i)-(iii)
    python chip_smoke.py --four    # four cards: the sharded paths only

One card, through the public model classes and ``run(n)``:

(i)   4096^2 pressure-driven pipe flow (the README headline workload), 5
      steps on the card against the numpy oracle of the same D2Q9 step
      (:mod:`lb2d_tpu.utils.oracle`), then timed as a smoke number.
(ii)  Poiseuille flow at N=200 run to dimensionless time 10; RMS error of
      the mean profile against theory, with the bound the CPU test uses.
(iii) BASELINE config 5 at 8192^2 (porous two-fluid Shan-Chen + screened
      Poisson, ``jnp.fft`` solve): a few steps, finite state, mass drift,
      timed as a smoke number; the same configuration at 1024^2 on the CPU
      and on the card must agree after 20 steps.

Four cards (``--four``): ``ShardedPipeFlow`` at 8192^2 on a (4, 1) mesh
against ``PipeFlow`` on one card, and config 5 at 4096^2 ``shard_over`` a
(4, 1) mesh (matmul-DFT solve) against one card (cuFFT); each sharded state
must span four devices with about a quarter of the one-card memory each.

Everything runs in this one process. The script exits non-zero, and prints
no result line, when JAX finds no GPU or any phase fails. Its last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# 4096^2 headline pipe flow (nx = ceil(pipe_length / L * N) + 1 = N + 1)
FLOW = dict(diameter=1.0, rho=1.0, viscosity=0.1, pressure_grad=-0.01,
            pipe_length=1.0)
# The CPU Poiseuille test's physical parameters (tests/test_pipe_flow.py)
POISEUILLE = dict(diameter=1.5, rho=10.0, viscosity=5.0,
                  pressure_grad=-100.0, pipe_length=3.0)
BYTES_PER_SITE = 72  # fp32 D2Q9: read + write 9 populations


def nvidia_smi() -> str:
    """The card's name and power limit, read by a child that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip()


def _on(device):
    import jax

    return (jax.default_device(device) if device is not None
            else contextlib.nullcontext())


def _report(name, value, limit, **extra):
    ok = bool(np.isfinite(value) and value <= limit)
    print(f"{name}: {value:.3e} (limit {limit:.1e}) {'ok' if ok else 'FAIL'}",
          flush=True)
    return dict(name=name, value=float(value), limit=limit, ok=ok, **extra)


def peak_bytes(device) -> int | None:
    stats = device.memory_stats() if device is not None else None
    return None if not stats else stats.get("peak_bytes_in_use")


def loop_body_kernels(hlo_text: str) -> int:
    """Kernel-launching instructions per iteration of the compiled
    ``fori_loop``: ops in the while body (and in computations it calls)
    that become device kernels or library calls."""
    comps, cur = {}, None
    for line in hlo_text.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if m:
            cur = comps.setdefault(m.group(1), [])
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            cur.append(line)
    kernel_ops = ("fusion", "custom-call", "copy", "copy-start", "fft",
                  "transpose", "reduce", "dot", "convolution", "sort",
                  "scatter", "gather", "dynamic-update-slice",
                  "collective-permute", "collective-permute-start",
                  "all-reduce", "all-reduce-start", "all-gather",
                  "all-gather-start", "all-to-all")

    def count(name, seen):
        n = 0
        for line in comps.get(name, ()):
            m = re.search(r"=\s*[^=]*?\s([a-z][a-z\-]*)\(", line)
            if not m:
                continue
            op = m.group(1)
            if op in kernel_ops:
                n += 1
            elif op in ("call", "conditional"):
                for callee in re.findall(
                        r"(?:to_apply|branch_computations|true_computation|"
                        r"false_computation)=\{?%?([\w.\-]+)", line):
                    if callee not in seen:
                        n += count(callee, seen | {callee})
        return n

    bodies = re.findall(r"body=%?([\w.\-]+)", hlo_text)
    return sum(count(b, {b}) for b in bodies)


def copy_probe_gbps(device=None, nbytes=1 << 30, reps=5) -> float:
    """Read+write bandwidth of a large elementwise pass, timed like a step."""
    import jax
    import jax.numpy as jnp

    with _on(device):
        x = jnp.zeros(nbytes // 4, jnp.float32)
        bump = jax.jit(lambda a: a + 1.0, donate_argnums=0)
        x = jax.block_until_ready(bump(x))
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            x = jax.block_until_ready(bump(x))
            times.append(time.perf_counter() - t0)
    return 2 * nbytes / float(np.median(times)) / 1e9


def _time_runs(run, sites, steps, reps):
    """Median per-step seconds of ``reps`` calls of ``run(steps)``, each
    ending in ``block_until_ready``; returns (step_s, mlups)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(steps)
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times)) / steps
    return step_s, sites / step_s / 1e6


def phase_flow(N=4095, steps=5, rtol=2e-5, atol=2e-6, timed_steps=50,
               reps=5, device=None):
    """(i) fp32 XLA flow step vs the fp64 numpy oracle, then timing."""
    import jax

    from lb2d_tpu.models.pipe_flow import PipeFlow
    from lb2d_tpu.utils.oracle import numpy_pipe_step

    with _on(device):
        sim = PipeFlow(N=N, **FLOW)
        f0 = np.asarray(sim.state, np.float64)
        sim.run(steps)
        got = np.asarray(sim.state, np.float64)
    expect = f0
    for _ in range(steps):
        expect = numpy_pipe_step(expect, sim.omega, sim.inlet_rho,
                                 sim.outlet_rho)
    # <= 1 is numpy.testing.assert_allclose(got, expect, rtol, atol)
    ratio = float(np.max(np.abs(got - expect) / (atol + rtol * np.abs(expect))))
    del f0, got, expect
    out = _report(f"phase (i) flow step vs numpy oracle {sim.ny}x{sim.nx}, "
                  f"{steps} steps, max |err|/(atol {atol:g} + rtol {rtol:g}"
                  f" |ref|)", ratio, 1.0)
    with _on(device):
        def run(n):
            jax.block_until_ready(sim.run(n).state)

        run(timed_steps)  # warm (same executable: n is a traced argument)
        step_s, mlups = _time_runs(run, sim.num_cells, timed_steps, reps)
        hlo = sim._run_compiled.lower(sim.state, np.int32(1)).compile()
    out.update(step_ms=step_s * 1e3, mlups=mlups,
               gbps_72=mlups * 1e6 * BYTES_PER_SITE / 1e9,
               kernels_per_step=loop_body_kernels(hlo.as_text()))
    return out


def phase_poiseuille(N=200, time_to_run=10.0, device=None):
    """(ii) Poiseuille profile vs theory; bound of the CPU test."""
    from lb2d_tpu.models.pipe_flow import PipeFlow

    with _on(device):
        sim = PipeFlow(N=N, **POISEUILLE)
        steps = int(time_to_run / sim.units.delta_t)
        sim.run(steps)
        fields = sim.get_physical_fields()
    mean_u = fields["u"].T.mean(axis=1)
    y = np.arange(mean_u.shape[0]) * sim.units.delta_x * sim.units.L
    p = POISEUILLE
    predicted = (p["pressure_grad"] / (2 * p["rho"] * p["viscosity"])
                 * y * (y - p["diameter"]))
    umax = float(predicted.max())
    err = float(np.sqrt(((mean_u - predicted) ** 2).mean()))
    return _report(f"phase (ii) Poiseuille N={N} ({sim.ny}x{sim.nx}, "
                   f"{steps} steps) RMS error vs theory [m/s]", err,
                   0.05 * umax)


def build_config5(size, seed=0):
    """BASELINE.json config 5 (``benchmarks/run_all.py``): porous two-fluid
    Shan-Chen (G = 1.5) + screened-Poisson repulsion (length 10, amplitude
    1e-4) on a ``size``^2 periodic grid, built on the default device."""
    from lb2d_tpu.models.multicomponent import Fluid, SimulationRunner

    sim = SimulationRunner(nx=size, ny=size, L_lb=size, T_lb=1.0,
                           num_populations=2, porous=True)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=0.8,
                            nu_fluid=1.0 / 6.0, K=10.0, Fe=0.1))
    sim.complete_setup()
    base = 0.5 + 0.05 * np.random.RandomState(seed).rand(
        size, size).astype(np.float32)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    sim.add_screened_poisson_force(0, 1, interaction_length=10.0,
                                   amplitude=1e-4)
    return sim


def _mass(sim):
    from lb2d_tpu.utils.metrics import accumulated_sum

    return accumulated_sum(sim.f, "f64")


def phase_config5(size=8192, steps=5, timed_steps=10, reps=3, ref_size=1024,
                  ref_steps=20, rtol=1e-5, drift_limit=1e-5, device=None,
                  ref_device=None):
    """(iii) config 5 at full size on ``device``, then the same
    configuration at ``ref_size`` on ``ref_device`` (the CPU) and on
    ``device``: max |f_card - f_cpu| / max |f_cpu| <= ``rtol``. Both run
    fp32, with cuFFT's summation order against the CPU FFT's; on the CPU,
    fp32 against fp64 differs by 5.3e-7 and the FFT against the matmul DFT
    by 3.1e-7 at 1024^2 after 20 steps, so ``rtol`` leaves 20x room."""
    import jax
    import jax.numpy as jnp

    results = []
    with _on(device):
        sim = build_config5(size)
        m0 = _mass(sim)
        sim.run(steps)
        finite = bool(jnp.isfinite(sim.f).all())
        drift = abs(_mass(sim) - m0) / m0
        hlo = sim._run_jit.lower(sim.f, np.int32(1)).compile()
        mem = hlo.memory_analysis()
        rates = [sim.run(timed_steps, timed=True).last_mlups
                 for _ in range(reps)]
        mlups = float(np.median(rates))
        step_s = sim.nx * sim.ny / mlups / 1e6
    print(f"phase (iii) config 5 {size}^2: backend_used={sim.backend_used}, "
          f"finite={finite}, memory_analysis: {mem}", flush=True)
    r = _report(f"phase (iii) config 5 {size}^2 relative mass drift over "
                f"{steps} steps", drift if finite else float("nan"),
                drift_limit, step_ms=step_s * 1e3, mlups=mlups,
                gbps_72=mlups * 1e6 * BYTES_PER_SITE * 2 / 1e9,
                kernels_per_step=loop_body_kernels(hlo.as_text()))
    r["ok"] = r["ok"] and finite and sim.backend_used == "xla"
    results.append(r)
    del sim, hlo

    with _on(ref_device):
        ref = build_config5(ref_size)
        ref.run(ref_steps)
        a = np.asarray(ref.f)
    del ref
    with _on(device):
        card = build_config5(ref_size)
        card.run(ref_steps)
        b = np.asarray(card.f)
    del card
    err = float(np.max(np.abs(b - a)) / np.max(np.abs(a)))
    results.append(_report(
        f"phase (iii) config 5 {ref_size}^2 card vs CPU after {ref_steps} "
        "steps, max |diff| / max |f_cpu|", err, rtol))
    jax.clear_caches()
    return results


def _sharding_check(name, arr, n_dev):
    """Each of ``n_dev`` devices holds one distinct 1/n_dev shard."""
    shards = arr.addressable_shards
    devs = {s.device for s in shards}
    sizes = {int(np.prod(s.data.shape)) for s in shards}
    ok = len(devs) == n_dev and sizes == {arr.size // n_dev}
    print(f"{name}: {len(devs)} devices, shard sizes {sorted(sizes)} of "
          f"{arr.size} {'ok' if ok else 'FAIL'}", flush=True)
    return dict(name=name, ok=ok)


def _per_device_bytes(compiled):
    m = compiled.memory_analysis()
    return (m.argument_size_in_bytes + m.output_size_in_bytes
            + m.temp_size_in_bytes - m.alias_size_in_bytes)


def four_pipe(size=8192, steps=20, rtol=1e-5, atol=5e-6, mem_limit=0.5,
              devices=None):
    """``ShardedPipeFlow`` on a (4, 1) mesh vs ``PipeFlow`` on one card.
    Each device's share of the compiled step's memory must stay below
    ``mem_limit`` of the one-card step's: the state is an exact quarter,
    but the sharded program keeps a halo-extended copy of its block, so
    its temporaries are not; a program that left the grid on one device
    would read 1 or more."""
    import jax

    from lb2d_tpu.models.pipe_flow import PipeFlow
    from lb2d_tpu.parallel.sharded import ShardedPipeFlow, make_mesh

    devices = list(devices if devices is not None else jax.devices())[:4]
    results = []
    kw = dict(N=size - 1, **FLOW)
    sh = ShardedPipeFlow(mesh=make_mesh(4, shape=(4, 1), devices=devices),
                         **kw)
    sh.run(steps)
    results.append(_sharding_check(
        f"--four ShardedPipeFlow {size}^2 state sharding", sh.state, 4))
    b = np.asarray(jax.device_get(sh.state))
    per_dev = _per_device_bytes(
        sh._run.lower(sh.state, np.int32(1)).compile())
    peaks = [peak_bytes(d) for d in devices]
    del sh
    with _on(devices[0]):
        one = PipeFlow(**kw)
        one.run(steps)
        a = np.asarray(one.state)
        whole = _per_device_bytes(
            one._run_compiled.lower(one.state, np.int32(1)).compile())
    del one
    print(f"--four pipe peak_bytes_in_use per device after the sharded run: "
          f"{peaks}", flush=True)
    ratio = float(np.max(np.abs(b - a) / (atol + rtol * np.abs(a))))
    results.append(_report(
        f"--four ShardedPipeFlow vs PipeFlow {size}^2 after {steps} steps, "
        f"max |err|/(atol {atol:g} + rtol {rtol:g} |ref|)", ratio, 1.0))
    results.append(_report(
        f"--four pipe per-device bytes, sharded / one card "
        f"({per_dev} / {whole})", per_dev / whole, mem_limit))
    return results


def four_config5(size=4096, steps=10, rtol=1e-5, mem_limit=0.5,
                 devices=None):
    """Config 5 ``shard_over`` a (4, 1) mesh (matmul DFT) vs one card
    (cuFFT); per-device memory as in :func:`four_pipe`."""
    import jax

    from lb2d_tpu.parallel.sharded import make_mesh

    devices = list(devices if devices is not None else jax.devices())[:4]
    results = []
    with _on(devices[0]):
        sh = build_config5(size)
    sh.shard_over(make_mesh(4, shape=(4, 1), devices=devices))
    sh.run(steps)
    results.append(_sharding_check(
        f"--four config 5 {size}^2 state sharding", sh.f, 4))
    per_dev = _per_device_bytes(sh._run_jit.lower(sh.f, np.int32(1)).compile())
    b = np.asarray(jax.device_get(sh.f))
    del sh
    with _on(devices[0]):
        one = build_config5(size)
        one.run(steps)
        a = np.asarray(one.f)
        whole = _per_device_bytes(
            one._run_jit.lower(one.f, np.int32(1)).compile())
    del one
    err = float(np.max(np.abs(b - a)) / np.max(np.abs(a)))
    results.append(_report(
        f"--four config 5 {size}^2 sharded (matmul DFT) vs one card (FFT) "
        f"after {steps} steps, max |diff| / max |f|", err, rtol))
    results.append(_report(
        f"--four config 5 per-device bytes, sharded / one card "
        f"({per_dev} / {whole})", per_dev / whole, mem_limit))
    return results


def run_one_card(device, ref_device):
    results = []
    gbps = copy_probe_gbps(device)
    print(f"copy probe (1 GiB read + write): {gbps:.1f} GB/s", flush=True)
    r = phase_flow(device=device)
    print(f"phase (a) smoke number, 4096^2 pipe flow: step median "
          f"{r['step_ms']:.4f} ms, {r['mlups']:.1f} MLUPS, 72-B/site "
          f"{r['gbps_72']:.1f} GB/s ({r['gbps_72'] / gbps:.3f} of the copy "
          f"probe), {r['kernels_per_step']} HLO kernel ops per step; "
          f"peak_bytes_in_use {peak_bytes(device)}", flush=True)
    results.append(r)
    r = phase_poiseuille(device=device)
    print(f"phase (ii) peak_bytes_in_use {peak_bytes(device)}", flush=True)
    results.append(r)
    rs = phase_config5(device=device, ref_device=ref_device)
    r = rs[0]
    print(f"phase (b) smoke number, config 5 8192^2: step median "
          f"{r['step_ms']:.4f} ms, {r['mlups']:.1f} MLUPS, 72-B/site/fluid "
          f"{r['gbps_72']:.1f} GB/s ({r['gbps_72'] / gbps:.3f} of the copy "
          f"probe), {r['kernels_per_step']} HLO kernel ops per step; "
          f"peak_bytes_in_use {peak_bytes(device)}", flush=True)
    results.extend(rs)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card sharded phases")
    args = parser.parse_args(argv)

    # the config-5 comparison needs the CPU backend beside the GPU one
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found platform "
              f"{dev.platform!r} ({dev.device_kind})", file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from lb2d_tpu.utils.compile_cache import configure_compile_cache

    print(f"compile cache: {configure_compile_cache()}", flush=True)
    print(nvidia_smi(), flush=True)
    print(f"device_kind: {dev.device_kind}, count: {len(devices)}",
          flush=True)
    if args.four:
        results = four_pipe(devices=devices) + four_config5(devices=devices)
    else:
        results = run_one_card(dev, jax.devices("cpu")[0])
    failed = [r["name"] for r in results if not r["ok"]]
    if failed:
        print("chip_smoke FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
