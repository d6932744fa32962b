// Native C++ CPU backend for the D2Q9 pipe-flow family.
//
// This is the framework's counterpart of the reference's compiled Cython
// extension (LB_D2Q9/dimensionless/cython_dim.pyx, built by setup.py:8-10):
// a host-CPU implementation of the same step the XLA path runs, used as a
// fast CPU fallback and as an independent cross-backend oracle (the
// reference verified python/cython/opencl against each other;
// we verify xla/native).
//
// Semantics match the OpenCL-verified update order (opencl_dim.py:372-387):
// stream -> Zou-He pressure BCs (D2Q9.cl:173-261) -> obstacle bounce-back
// (D2Q9.cl:398-433) -> moments -> feq (D2Q9.cl:45-62 or the He-Luo variant
// D2Q9i.cl) -> BGK collide. Streaming wraps periodically; the BC rewrite
// covers exactly the wrapped-in populations (see lb2d_tpu/ops/stream.py).
//
// Layout: f[9][ny][nx] row-major float32 (identical to the JAX arrays).
// OpenMP parallel over rows.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

namespace {

constexpr int Q = 9;
constexpr int CX[Q] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
constexpr int CY[Q] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
constexpr int OPP[Q] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
constexpr float W[Q] = {4.f / 9.f, 1.f / 9.f, 1.f / 9.f, 1.f / 9.f,
                        1.f / 9.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f,
                        1.f / 36.f};
constexpr float CS2 = 1.f / 3.f;

inline int wrap(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

struct Grid {
  int ny, nx;
  inline long plane() const { return (long)ny * nx; }
};

// ---------------------------------------------------------------------------
// streaming: dst[j][y][x] = src[j][y - cy][x - cx] (periodic)
// ---------------------------------------------------------------------------
void stream(const float* src, float* dst, Grid g) {
  const long P = g.plane();
  for (int j = 0; j < Q; ++j) {
    const float* s = src + j * P;
    float* d = dst + j * P;
    const int cx = CX[j], cy = CY[j];
#pragma omp parallel for schedule(static)
    for (int y = 0; y < g.ny; ++y) {
      const int sy = wrap(y - cy, g.ny);
      const float* srow = s + (long)sy * g.nx;
      float* drow = d + (long)y * g.nx;
      if (cx == 0) {
        std::memcpy(drow, srow, sizeof(float) * g.nx);
      } else if (cx == 1) {
        drow[0] = srow[g.nx - 1];
        std::memcpy(drow + 1, srow, sizeof(float) * (g.nx - 1));
      } else {  // cx == -1
        std::memcpy(drow, srow + 1, sizeof(float) * (g.nx - 1));
        drow[g.nx - 1] = srow[0];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Zou-He pressure BCs + walls + corners (D2Q9.cl:173-261 / D2Q9i.cl)
// ---------------------------------------------------------------------------
void apply_bcs(float* f, Grid g, float inlet_rho, float outlet_rho,
               bool incompressible) {
  const long P = g.plane();
  const int nx = g.nx, ny = g.ny;
  auto at = [&](int j, int y, int x) -> float& {
    return f[j * P + (long)y * nx + x];
  };
  auto snap = [&](int y, int x, float* s) {
    for (int j = 0; j < Q; ++j) s[j] = at(j, y, x);
  };

  // inlet column x = 0, interior rows
#pragma omp parallel for schedule(static)
  for (int y = 1; y < ny - 1; ++y) {
    float s[Q];
    snap(y, 0, s);
    if (incompressible) {
      float u = -s[0] - s[2] - 2 * s[3] - s[4] - 2 * s[6] - 2 * s[7] + inlet_rho;
      at(1, y, 0) = (1.f / 3.f) * (3 * s[3] + 2 * u);
      at(5, y, 0) = (1.f / 6.f) * (-3 * s[2] + 3 * s[4] + 6 * s[7] + u);
      at(8, y, 0) = (1.f / 6.f) * (3 * s[2] - 3 * s[4] + 6 * s[6] + u);
    } else {
      float u = -((s[0] + s[2] + 2 * s[3] + s[4] + 2 * s[6] + 2 * s[7]
                   - inlet_rho) / inlet_rho);
      at(1, y, 0) = s[3] + (2.f / 3.f) * inlet_rho * u;
      at(5, y, 0) = -.5f * s[2] + .5f * s[4] + s[7] + (1.f / 6.f) * u * inlet_rho;
      at(8, y, 0) = .5f * s[2] - .5f * s[4] + s[6] + (1.f / 6.f) * u * inlet_rho;
    }
    // outlet column x = nx-1
    snap(y, nx - 1, s);
    if (incompressible) {
      float u = s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5] + 2 * s[8] - outlet_rho;
      at(3, y, nx - 1) = (1.f / 3.f) * (3 * s[1] - 2 * u);
      at(6, y, nx - 1) = (1.f / 6.f) * (-3 * s[2] + 3 * s[4] + 6 * s[8] - u);
      at(7, y, nx - 1) = (1.f / 6.f) * (3 * s[2] - 3 * s[4] + 6 * s[5] - u);
    } else {
      float u = -1.f + (s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5] + 2 * s[8])
                          / outlet_rho;
      at(3, y, nx - 1) = s[1] - (2.f / 3.f) * outlet_rho * u;
      at(6, y, nx - 1) = -.5f * s[2] + .5f * s[4] + s[8]
                         - (1.f / 6.f) * u * outlet_rho;
      at(7, y, nx - 1) = .5f * s[2] - .5f * s[4] + s[5]
                         - (1.f / 6.f) * u * outlet_rho;
    }
  }

  // solid walls, interior columns
#pragma omp parallel for schedule(static)
  for (int x = 1; x < nx - 1; ++x) {
    float s[Q];
    snap(ny - 1, x, s);  // north
    at(4, ny - 1, x) = s[2];
    at(8, ny - 1, x) = .5f * (-s[1] + s[3] + 2 * s[6]);
    at(7, ny - 1, x) = .5f * (s[1] - s[3] + 2 * s[5]);
    snap(0, x, s);  // south
    at(2, 0, x) = s[4];
    at(6, 0, x) = .5f * (s[1] - s[3] + 2 * s[8]);
    at(5, 0, x) = .5f * (-s[1] + s[3] + 2 * s[7]);
  }

  // corners (D2Q9.cl:228-259)
  float s[Q];
  snap(0, 0, s);  // bottom inlet
  at(1, 0, 0) = s[3];
  at(2, 0, 0) = s[4];
  at(5, 0, 0) = s[7];
  at(6, 0, 0) = at(8, 0, 0) =
      .5f * (-s[0] - 2 * s[3] - 2 * s[4] - 2 * s[7] + inlet_rho);
  snap(ny - 1, 0, s);  // top inlet
  at(1, ny - 1, 0) = s[3];
  at(4, ny - 1, 0) = s[2];
  at(8, ny - 1, 0) = s[6];
  at(5, ny - 1, 0) = at(7, ny - 1, 0) =
      .5f * (-s[0] - 2 * s[2] - 2 * s[3] - 2 * s[6] + inlet_rho);
  snap(0, nx - 1, s);  // bottom outlet
  at(3, 0, nx - 1) = s[1];
  at(2, 0, nx - 1) = s[4];
  at(6, 0, nx - 1) = s[8];
  at(5, 0, nx - 1) = at(7, 0, nx - 1) =
      .5f * (-s[0] - 2 * s[1] - 2 * s[4] - 2 * s[8] + outlet_rho);
  snap(ny - 1, nx - 1, s);  // top outlet
  at(3, ny - 1, nx - 1) = s[1];
  at(4, ny - 1, nx - 1) = s[2];
  at(7, ny - 1, nx - 1) = s[5];
  at(6, ny - 1, nx - 1) = at(8, ny - 1, nx - 1) =
      .5f * (-s[0] - 2 * s[1] - 2 * s[2] - 2 * s[5] + outlet_rho);
}

// full bounce-back inside the obstacle mask (D2Q9.cl:398-433)
void bounce_back(float* f, const int32_t* mask, Grid g) {
  const long P = g.plane();
#pragma omp parallel for schedule(static)
  for (long i = 0; i < P; ++i) {
    if (mask[i]) {
      float s[Q];
      for (int j = 0; j < Q; ++j) s[j] = f[j * P + i];
      for (int j = 1; j < Q; ++j) f[j * P + i] = s[OPP[j]];
    }
  }
}

// moments + feq + BGK collide, in place
void collide(float* f, Grid g, float omega, bool incompressible) {
  const long P = g.plane();
  const float A = 1.f - omega;
#pragma omp parallel for schedule(static)
  for (long i = 0; i < P; ++i) {
    float s[Q];
    for (int j = 0; j < Q; ++j) s[j] = f[j * P + i];
    const float rho = s[0] + s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7]
                      + s[8];
    float u = s[1] - s[3] + s[5] - s[6] - s[7] + s[8];
    float v = s[5] + s[2] + s[6] - s[7] - s[4] - s[8];
    if (!incompressible) {
      const float inv = 1.f / rho;
      u *= inv;
      v *= inv;
    }
    const float usq = u * u + v * v;
    for (int j = 0; j < Q; ++j) {
      const float cu = CX[j] * u + CY[j] * v;
      const float quad = cu / CS2 + cu * cu / (2 * CS2 * CS2)
                         - usq / (2 * CS2);
      const float feq = incompressible ? W[j] * (rho + quad)
                                       : W[j] * rho * (1.f + quad);
      f[j * P + i] = s[j] * A + omega * feq;
    }
  }
}

}  // namespace

extern "C" {

// Advance n_steps; f and f_tmp are [9 * ny * nx] float32 buffers. The result
// is guaranteed to end in f. mask may be null.
void lb2d_run(float* f, float* f_tmp, const int32_t* mask, int ny, int nx,
              float omega, float inlet_rho, float outlet_rho,
              int incompressible, int n_steps) {
  Grid g{ny, nx};
  float* cur = f;
  float* tmp = f_tmp;
  for (int it = 0; it < n_steps; ++it) {
    stream(cur, tmp, g);
    apply_bcs(tmp, g, inlet_rho, outlet_rho, incompressible != 0);
    if (mask) bounce_back(tmp, mask, g);
    collide(tmp, g, omega, incompressible != 0);
    std::swap(cur, tmp);
  }
  if (cur != f)
    std::memcpy(f, cur, sizeof(float) * Q * g.plane());
}

}  // extern "C"
