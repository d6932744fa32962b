#!/bin/bash
# Regenerate the committed verification artifacts in docs/ (any JAX device;
# a GPU makes the N=200 Poiseuille run quick).
# Counterpart of the reference's rendered proof
# (docs/opencl_dimensionless_verification.ipynb,
# pictures/resolution_convergence.png, the cs205 vortex movies): the same
# acceptance results as committed, viewable artifacts.
#
# Usage: bash docs/regen.sh      (from the repo root)
set -e
cd "$(dirname "$0")/.."

# 1. Poiseuille resolution-convergence figure (reference:
#    pictures/resolution_convergence.png)
python examples/poiseuille_verification.py docs/poiseuille_verification.png

# 2. Karman-street frame strip (reference: docs/cs205_movie.ipynb — the
#    obstacle-flow movie workload, here at a Reynolds number that sheds)
python examples/karman_street.py /tmp/karman_frames 80 150
python - <<'EOF'
import numpy as np
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

frames = [plt.imread(f"/tmp/karman_frames/frame_{k:04d}.png")
          for k in (73, 75, 77, 79)]
strip = np.concatenate(frames, axis=0)   # 4 late frames, stacked
plt.imsave("docs/vortex_shedding_strip.png", strip)
print("wrote docs/vortex_shedding_strip.png")
EOF

# 3. LiveView HTML sample (the interactive-window counterpart)
python - <<'EOF'
from lb2d_tpu.models import PipeFlowCylinder
from lb2d_tpu.utils.render import LiveView

D = 1.5
sim = PipeFlowCylinder(cylinder_center=(0.75, 0.75), cylinder_radius=D / 15,
                       diameter=D, rho=10.0, viscosity=0.25,
                       pressure_grad=-10.0, pipe_length=3 * D, N=40)
view = LiveView(sim, field="u", steps_per_frame=400)
view.to_html("docs/live_view_sample.html", num_frames=12, scale=2)
print("wrote docs/live_view_sample.html")
EOF
