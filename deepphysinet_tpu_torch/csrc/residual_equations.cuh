// The six primitive-equation residuals of one point, in device code.
//
// Twin of deepphysinet_tpu_torch/physics/equations.py (and of the JAX package's
// physics/equations.py, which Pallas traces into its residual kernels): the same
// formulas term by term, in the same order of operations, in float32.  A change
// to one file is made to the other; chip_smoke.py holds the two together on the
// card (the residual-sum kernels against their plain versions).
//
// Every operation is an explicitly rounded one (__fmul_rn, __fadd_rn, ...), which
// nvcc never contracts: it would otherwise fuse a * b + c into one FMA, PyTorch's
// elementwise kernels do not, and the residuals are differences of large terms
// (the gas law subtracts two pressures of 1e5 Pa), where the one rounding that an
// FMA saves is visible.  Division is IEEE division, exp is expf; the file must
// not be compiled with --use_fast_math.

#pragma once

#include <cuda_runtime.h>

namespace dpn {

// Inverse normalization and clip of the six variables (u, v, p, T, q, rho),
// the physical constants, and products of constants that equations.py forms in
// double precision before they meet a tensor (c_p * r_v, latent_heat ** 2).
struct ResidualParams {
  float std[6], mean[6];
  float lo[6], hi[6];
  int clip[6];  // 1: the variable is clipped to (lo, hi) and its derivative masked
  float c_p, r_d, latent_heat, eps_rho, cp_rv, latent_heat_sq;
};

namespace eq {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

enum { U = 0, V, P, TT, Q, RHO };  // variables
enum { X = 0, Y, T };              // directions

// Physical fields and derivatives of one point: fld[var], d[var][direction].
struct Point {
  float fld[6];
  float d[6][3];
};

// Normalized decode outputs -> physical values (o * std + mean), clipped where
// the variable clips; the clip mask comes from the UNCLIPPED value with strict
// bounds, and a derivative is std * tangent inside the bounds and 0 outside.
__device__ __forceinline__ void to_physical(const ResidualParams& prm, int v, float o,
                                            const float (&to)[3], Point& pt) {
  float phys = add(mul(o, prm.std[v]), prm.mean[v]);
  float scale = prm.std[v];
  if (prm.clip[v]) {
    const bool inside = phys > prm.lo[v] && phys < prm.hi[v];
    phys = fminf(fmaxf(phys, prm.lo[v]), prm.hi[v]);
    scale = inside ? scale : 0.0f;
  }
  pt.fld[v] = phys;
#pragma unroll
  for (int k = 0; k < 3; ++k) pt.d[v][k] = mul(to[k], scale);
}

// D(var)/Dt = var_t + u var_x + v var_y, summed left to right
__device__ __forceinline__ float advect(const Point& pt, int var) {
  return add(add(pt.d[var][T], mul(pt.fld[U], pt.d[var][X])), mul(pt.fld[V], pt.d[var][Y]));
}

// Tetens formula (saturation_specific_humidity)
__device__ __forceinline__ float saturation_specific_humidity(float p, float temp) {
  const float t = sub(temp, 273.15f);
  const float e_s = mul(mul(6.112f, expf(dvd(mul(17.67f, t), add(t, 243.5f)))), 100.0f);
  return dvd(mul(0.622f, e_s), sub(p, mul(0.378f, e_s)));
}

// out[e] = diff_e - const_e for the equations in the order (momentum_u,
// momentum_v, continuity, energy, vapor, gas); f is the Coriolis parameter.
__device__ __forceinline__ void residuals(const ResidualParams& c, const Point& pt, float f,
                                          float (&out)[6]) {
  const float u = pt.fld[U], v = pt.fld[V], p = pt.fld[P], temp = pt.fld[TT], q = pt.fld[Q],
              rho = pt.fld[RHO];

  // u momentum: u_t + u u_x + v u_y + p_x / rho = f v
  out[0] = sub(add(advect(pt, U), dvd(pt.d[P][X], rho)), mul(f, v));
  // v momentum: v_t + u v_x + v v_y + p_y / rho = -f u
  out[1] = sub(add(advect(pt, V), dvd(pt.d[P][Y], rho)), mul(-f, u));
  // continuity: rho_t + u rho_x + v rho_y + rho u_x + rho v_y = 0
  out[2] = add(add(advect(pt, RHO), mul(rho, pt.d[U][X])), mul(rho, pt.d[V][Y]));
  // energy: c_p DT/Dt - Dp/Dt / (rho + eps) + L Dq/Dt = 0
  const float dp = advect(pt, P), dq = advect(pt, Q);
  const float t_term = mul(c.c_p, advect(pt, TT));
  const float p_term = dvd(-dp, add(rho, c.eps_rho));
  const float q_term = mul(c.latent_heat, dq);
  out[3] = add(add(t_term, p_term), q_term);
  // vapor: Dq/Dt - delta F / (p + eps) Dp/Dt = 0
  float q_s = saturation_specific_humidity(p, temp);
  q_s = q_s < 1e-6f ? 1e-6f : q_s;  // maximum(q_s, 1e-6), a NaN kept
  const float delta = (dp < 0.0f && q >= q_s) ? 1.0f : 0.0f;
  const float r_moist = mul(add(1.0f, mul(0.608f, q)), c.r_d);
  float f_fac = dvd(sub(mul(c.latent_heat, r_moist), mul(c.cp_rv, temp)),
                    add(add(c.cp_rv, mul(temp, temp)), mul(c.latent_heat_sq, q_s)));
  f_fac = mul(mul(f_fac, q_s), temp);
  out[4] = add(dvd(mul(mul(-dp, delta), f_fac), add(p, c.eps_rho)), dq);
  // gas: p = rho (1 + 0.608 q) R_d T
  out[5] = sub(p, mul(mul(mul(rho, add(1.0f, mul(0.608f, q))), c.r_d), temp));
}

}  // namespace eq
}  // namespace dpn
