"""Watch a simulation live — terminal ANSI rendering or an HTML animation.

The reference opens a vispy OpenGL window (`field_visualizer.py`); in a
headless environment the equivalents are a truecolor terminal loop and
a self-contained HTML page (every frame rendered on device, only uint8
images cross to the host).

Usage:
  python examples/live_view.py                 # 60 frames in the terminal
  python examples/live_view.py --html out.html # write an HTML animation
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from lb2d_tpu.models import PipeFlowObstacles, disk_mask
    from lb2d_tpu.utils.render import LiveView

    ny, nx = 256, 512
    mask = disk_mask(nx, ny, cx=nx // 4, cy=ny // 2 + 3, radius=ny // 10)
    sim = PipeFlowObstacles(
        obstacle_mask=mask, diameter=1.5, rho=10.0, viscosity=0.12,
        pressure_grad=-2.5, pipe_length=1.5 * (nx - 1.5) / (ny - 1),
        N=ny - 1)
    lv = LiveView(sim, field="u", steps_per_frame=200, cmap="magma")

    if "--html" in sys.argv:
        path = sys.argv[sys.argv.index("--html") + 1]
        lv.to_html(path, num_frames=60, fps=15)
        print(f"wrote {path} ({os.path.getsize(path)/1e6:.1f} MB) — "
              "open in any browser")
    else:
        lv.to_terminal(num_frames=60, max_cols=110)


if __name__ == "__main__":
    main()
