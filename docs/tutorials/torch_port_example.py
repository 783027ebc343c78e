"""Tutorial 6: the PyTorch/CUDA port (`transport_analysis_tpu_torch`).

The port computes the same analyses with the same public names as the
JAX package, in PyTorch: on an NVIDIA H100 through kernels written by
hand in CUDA C++, or on the CPU through their plain PyTorch versions. It
never imports jax. Its default device is the card; this tutorial asks
for the CPU (`device="cpu"`), so it runs anywhere in a few seconds.

Every run records `analysis.timing`: the "io" stage (reading the
trajectory and feeding the device), the "compute" stage (the
correlations), the total, and the throughputs.

Runnable on CPU, from the repository root:
PYTHONPATH=. python docs/tutorials/torch_port_example.py
"""

import numpy as np

import transport_analysis_tpu_torch as tat
from transport_analysis_tpu_torch import EinsteinMSD, VelocityAutocorr
from transport_analysis_tpu_torch import ViscosityHelfand
from transport_analysis_tpu_torch.data.files import ec_top, ec_traj_trr

# the generated ethylene-carbonate system (written on first access)
u = tat.Universe(ec_top, ec_traj_trr)
print(f"port {tat.__version__}: {len(u.atoms)} atoms, "
      f"{u.trajectory.n_frames} frames")


# --- VACF and Green–Kubo self-diffusivity of the carbonyl oxygens ------
vacf = VelocityAutocorr(u.select_atoms("name O3"), device="cpu").run()
print("VACF(0..3):", np.round(vacf.results.timeseries[:4], 3), "(Å/ps)²")
print("D_GK      :", vacf.self_diffusivity_gk(), "Å²/ps")
print("timing    :", vacf.timing.as_dict())


# --- Einstein–Helfand viscosity of the whole system --------------------
visc = ViscosityHelfand(u.atoms, temp_avg=300.0,
                        linear_fit_window=(10, 40), device="cpu").run()
print("viscosity slope:", visc.results.viscosity)
print("timing         :", visc.timing.as_dict())


# --- Einstein MSD of the ring carbons, FFT and windowed ----------------
msd = EinsteinMSD(u, select="name C1", device="cpu").run()
msd_w = EinsteinMSD(u, select="name C1", fft=False, device="cpu").run()
print("MSD(1..3):", np.round(msd.results.timeseries[1:4], 4), "Å²")
print("FFT vs windowed:", np.abs(msd.results.timeseries
                                 - msd_w.results.timeseries).max())
print("timing  :", msd.timing.as_dict())


# --- On the card, and over a mesh (shown, not run here) ----------------
#
# On an H100 drop `device="cpu"`: the analyses run the CUDA kernels, and
# "compute" covers the work queued on the card (the timer synchronises
# it before reading the clock):
#
#     vacf = VelocityAutocorr(u.select_atoms("name O3")).run()
#
# Over a mesh, each particle shard runs on its device; four shards of
# one card, or every visible card:
#
#     from transport_analysis_tpu_torch import parallel
#     with parallel.use_mesh(parallel.analysis_mesh(["cuda"] * 4)):
#         vacf = VelocityAutocorr(u.select_atoms("name O3")).run()
#
# A Chrome trace of a run, the card's kernels included:
#
#     from transport_analysis_tpu_torch.utils.profiling import trace
#     with trace("traces/"):
#         VelocityAutocorr(u.select_atoms("name O3")).run()
#
# The same mesh on the CPU, here:
from transport_analysis_tpu_torch import parallel  # noqa: E402

with parallel.use_mesh(parallel.analysis_mesh(["cpu"] * 4)):
    sharded = VelocityAutocorr(u.select_atoms("name O3"), device="cpu").run()
print("4 CPU shards vs unsharded:", np.abs(
    sharded.results.timeseries - vacf.results.timeseries).max())
