// Native PnP + RANSAC + LM pose solver (host-side C++).
//
// Replaces the reference's external native solvers (pycolmap
// absolute_pose_estimation, cv2.solvePnPRansac AP3P + solvePnPRefineLM —
// nerfmatch/utils/geometry.py:189-265) with an in-tree implementation:
//
//   * Grunert P3P minimal solver (quartic via Durand-Kerner iteration,
//     rigid alignment via orthonormal-triad absolute orientation),
//   * LO-RANSAC: adaptive iteration count, local LM optimization each time a
//     new best model is found,
//   * Levenberg-Marquardt refinement on inliers with analytic Jacobians
//     (right-perturbation so(3) parametrization, 6x6 Cholesky).
//
// All math is double precision on the host CPU; no external dependencies.
// The Python ctypes wrapper lives in nerfmatch_tpu_torch/pose/__init__.py.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

// ---------------------------------------------------------------------------
// Small vector/matrix helpers (row-major 3x3)
// ---------------------------------------------------------------------------

struct V3 {
  double x, y, z;
};

inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(double s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double norm(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 normalize(V3 a) {
  double n = norm(a);
  return n > 0 ? (1.0 / n) * a : a;
}

struct M3 {
  double m[9];
  V3 mul(V3 v) const {
    return {m[0] * v.x + m[1] * v.y + m[2] * v.z,
            m[3] * v.x + m[4] * v.y + m[5] * v.z,
            m[6] * v.x + m[7] * v.y + m[8] * v.z};
  }
  M3 mulM(const M3& o) const {
    M3 r;
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) {
        double s = 0;
        for (int k = 0; k < 3; k++) s += m[3 * i + k] * o.m[3 * k + j];
        r.m[3 * i + j] = s;
      }
    return r;
  }
  M3 t() const {
    return {{m[0], m[3], m[6], m[1], m[4], m[7], m[2], m[5], m[8]}};
  }
};

inline M3 from_cols(V3 a, V3 b, V3 c) {
  return {{a.x, b.x, c.x, a.y, b.y, c.y, a.z, b.z, c.z}};
}

// Rodrigues: axis-angle -> R
M3 rodrigues(V3 w) {
  double th = norm(w);
  M3 I = {{1, 0, 0, 0, 1, 0, 0, 0, 1}};
  if (th < 1e-12) return I;
  V3 a = (1.0 / th) * w;
  double c = std::cos(th), s = std::sin(th);
  M3 K = {{0, -a.z, a.y, a.z, 0, -a.x, -a.y, a.x, 0}};
  M3 K2 = K.mulM(K);
  M3 R;
  for (int i = 0; i < 9; i++) R.m[i] = I.m[i] + s * K.m[i] + (1 - c) * K2.m[i];
  return R;
}

// ---------------------------------------------------------------------------
// Quartic roots (Durand-Kerner on the monic polynomial)
// ---------------------------------------------------------------------------

int quartic_real_roots(const double c[5], double roots[4]) {
  // c[0] x^4 + ... + c[4]; returns count of (approximately) real roots.
  // A vanishing leading coefficient deflates to the cubic/quadratic/
  // linear polynomial instead of discarding valid P3P solutions.
  int lead = 0;
  while (lead < 3 && std::fabs(c[lead]) < 1e-14) lead++;
  int deg = 4 - lead;
  if (deg == 1) {
    if (std::fabs(c[3]) < 1e-300) return 0;
    roots[0] = -c[4] / c[3];
    return 1;
  }
  std::complex<double> a[4];
  for (int i = 1; i <= deg; i++) a[i - 1] = c[lead + i] / c[lead];
  auto poly = [&](std::complex<double> x) {
    std::complex<double> y(1.0, 0.0);
    for (int i = 0; i < deg; i++) y = y * x + a[i];
    return y;
  };
  std::complex<double> r[4] = {{0.4, 0.9}, {-0.91, 0.4}, {-0.4, -0.9}, {0.9, -0.41}};
  for (int it = 0; it < 80; it++) {
    double delta = 0;
    for (int i = 0; i < deg; i++) {
      std::complex<double> den(1.0, 0.0);
      for (int j = 0; j < deg; j++)
        if (j != i) den *= (r[i] - r[j]);
      std::complex<double> step = poly(r[i]) / den;
      r[i] -= step;
      delta += std::abs(step);
    }
    if (delta < 1e-14) break;
  }
  int n = 0;
  for (int i = 0; i < deg; i++) {
    if (std::fabs(r[i].imag()) < 1e-6 * (1.0 + std::fabs(r[i].real())))
      roots[n++] = r[i].real();
  }
  return n;
}

// ---------------------------------------------------------------------------
// Grunert P3P
// ---------------------------------------------------------------------------

// World points pw[3], unit bearing vectors f[3] (camera frame).
// Outputs up to 4 poses (R world->cam, t) ; returns count.
int p3p_grunert(const V3 pw[3], const V3 f[3], M3 R_out[4], V3 t_out[4]) {
  double a = norm(pw[1] - pw[2]);  // side opposite p1
  double b = norm(pw[0] - pw[2]);  // opposite p2
  double c = norm(pw[0] - pw[1]);  // opposite p3
  if (a < 1e-12 || b < 1e-12 || c < 1e-12) return 0;
  double ca = dot(f[1], f[2]);  // cos(alpha): angle subtending side a
  double cb = dot(f[0], f[2]);
  double cg = dot(f[0], f[1]);

  double a2 = a * a, b2 = b * b, c2 = c * c;
  double q1 = (a2 - c2) / b2;
  double q2 = (a2 + c2) / b2;

  // Quartic in v = s3/s1 (Haralick et al., "Review and Analysis of
  // Solutions of the Three Point Perspective Pose Estimation Problem").
  double A4 = (q1 - 1.0) * (q1 - 1.0) - 4.0 * c2 / b2 * ca * ca;
  double A3 = 4.0 * (q1 * (1.0 - q1) * cb - (1.0 - q2) * ca * cg +
                     2.0 * c2 / b2 * ca * ca * cb);
  double A2 = 2.0 * (q1 * q1 - 1.0 + 2.0 * q1 * q1 * cb * cb +
                     2.0 * (b2 - c2) / b2 * ca * ca -
                     4.0 * q2 * ca * cb * cg + 2.0 * (b2 - a2) / b2 * cg * cg);
  double A1 = 4.0 * (-q1 * (1.0 + q1) * cb + 2.0 * a2 / b2 * cg * cg * cb -
                     (1.0 - q2) * ca * cg);
  double A0 = (1.0 + q1) * (1.0 + q1) - 4.0 * a2 / b2 * cg * cg;

  double coeffs[5] = {A4, A3, A2, A1, A0};
  double vs[4];
  int nv = quartic_real_roots(coeffs, vs);

  int count = 0;
  for (int i = 0; i < nv && count < 4; i++) {
    double v = vs[i];
    if (!(v > 0)) continue;
    // u = s2/s1: u = ((-1+q1) v^2 - 2 q1 cb v + 1 + q1) / (2 (cg - v ca))
    double num = 2.0 * (cg - v * ca);
    if (std::fabs(num) < 1e-14) continue;
    double u = ((q1 - 1.0) * v * v - 2.0 * q1 * cb * v + 1.0 + q1) / num;
    if (!(u > 0)) continue;
    // s1 from law of cosines on side c: c^2 = s1^2 (1 + u^2 - 2 u cg)
    double k = 1.0 + u * u - 2.0 * u * cg;
    if (k < 1e-14) continue;
    double s1 = c / std::sqrt(k);
    double s2 = u * s1;
    double s3 = v * s1;
    if (!(s1 > 0 && s2 > 0 && s3 > 0)) continue;

    V3 pc[3] = {s1 * f[0], s2 * f[1], s3 * f[2]};

    // Absolute orientation via orthonormal triads (3 points).
    V3 e1w = normalize(pw[1] - pw[0]);
    V3 aw = pw[2] - pw[0];
    V3 e3w = normalize(cross(e1w, aw));
    if (norm(cross(e1w, aw)) < 1e-12) continue;  // collinear
    V3 e2w = cross(e3w, e1w);
    V3 e1c = normalize(pc[1] - pc[0]);
    V3 ac = pc[2] - pc[0];
    V3 e3c = normalize(cross(e1c, ac));
    V3 e2c = cross(e3c, e1c);
    M3 Cw = from_cols(e1w, e2w, e3w);
    M3 Cc = from_cols(e1c, e2c, e3c);
    M3 R = Cc.mulM(Cw.t());
    V3 t = pc[0] - R.mul(pw[0]);
    R_out[count] = R;
    t_out[count] = t;
    count++;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Reprojection + scoring
// ---------------------------------------------------------------------------

struct Cam {
  double fx, fy, cx, cy;
};

inline bool project(const Cam& cam, const M3& R, V3 t, V3 pw, double* u,
                    double* v) {
  V3 pc = R.mul(pw) + t;
  if (pc.z < 1e-9) return false;
  *u = cam.fx * pc.x / pc.z + cam.cx;
  *v = cam.fy * pc.y / pc.z + cam.cy;
  return true;
}

int count_inliers(const Cam& cam, const M3& R, V3 t, const double* p2d,
                  const double* p3d, int n, double thr2, uint8_t* mask,
                  double* sum_err) {
  int cnt = 0;
  double serr = 0;
  for (int i = 0; i < n; i++) {
    double u = 0.0, v = 0.0;  // project() leaves them unset behind camera
    V3 pw = {p3d[3 * i], p3d[3 * i + 1], p3d[3 * i + 2]};
    bool ok = project(cam, R, t, pw, &u, &v);
    double du = u - p2d[2 * i], dv = v - p2d[2 * i + 1];
    double e2 = du * du + dv * dv;
    bool in = ok && e2 < thr2;
    if (mask) mask[i] = in ? 1 : 0;
    if (in) {
      cnt++;
      serr += e2;
    }
  }
  if (sum_err) *sum_err = serr;
  return cnt;
}

// ---------------------------------------------------------------------------
// Levenberg-Marquardt refinement (6-DoF, masked points)
// ---------------------------------------------------------------------------

bool chol_solve6(double A[36], double b[6], double x[6]) {
  double L[36] = {0};
  for (int i = 0; i < 6; i++) {
    for (int j = 0; j <= i; j++) {
      double s = A[6 * i + j];
      for (int k = 0; k < j; k++) s -= L[6 * i + k] * L[6 * j + k];
      if (i == j) {
        if (s <= 0) return false;
        L[6 * i + j] = std::sqrt(s);
      } else {
        L[6 * i + j] = s / L[6 * j + j];
      }
    }
  }
  double y[6];
  for (int i = 0; i < 6; i++) {
    double s = b[i];
    for (int k = 0; k < i; k++) s -= L[6 * i + k] * y[k];
    y[i] = s / L[6 * i + i];
  }
  for (int i = 5; i >= 0; i--) {
    double s = y[i];
    for (int k = i + 1; k < 6; k++) s -= L[6 * k + i] * x[k];
    x[i] = s / L[6 * i + i];
  }
  return true;
}

double total_cost(const Cam& cam, const M3& R, V3 t, const double* p2d,
                  const double* p3d, int n, const uint8_t* mask) {
  double cost = 0;
  for (int i = 0; i < n; i++) {
    if (mask && !mask[i]) continue;
    V3 pw = {p3d[3 * i], p3d[3 * i + 1], p3d[3 * i + 2]};
    V3 pc = R.mul(pw) + t;
    double z = std::max(pc.z, 1e-9);
    double du = cam.fx * pc.x / z + cam.cx - p2d[2 * i];
    double dv = cam.fy * pc.y / z + cam.cy - p2d[2 * i + 1];
    cost += du * du + dv * dv;
  }
  return cost;
}

void refine_lm(const Cam& cam, M3* R, V3* t, const double* p2d,
               const double* p3d, int n, const uint8_t* mask, int iters) {
  double lambda = 1e-3;
  double cost = total_cost(cam, *R, *t, p2d, p3d, n, mask);
  for (int it = 0; it < iters; it++) {
    double JtJ[36] = {0};
    double Jtr[6] = {0};
    for (int i = 0; i < n; i++) {
      if (mask && !mask[i]) continue;
      V3 pw = {p3d[3 * i], p3d[3 * i + 1], p3d[3 * i + 2]};
      V3 pc = R->mul(pw) + *t;
      double z = std::max(pc.z, 1e-9);
      double iz = 1.0 / z, iz2 = iz * iz;
      double ru = cam.fx * pc.x * iz + cam.cx - p2d[2 * i];
      double rv = cam.fy * pc.y * iz + cam.cy - p2d[2 * i + 1];
      // d proj / d pc
      double Ju[3] = {cam.fx * iz, 0, -cam.fx * pc.x * iz2};
      double Jv[3] = {0, cam.fy * iz, -cam.fy * pc.y * iz2};
      // d pc / d [theta(3), t(3)] with right perturbation: R exp([d]x) pw + t
      //   d pc/d theta = -R [pw]x ; d pc/d t = I
      V3 Rp[3];  // columns of -R [pw]x = R [pw]x^T... compute directly:
      // [pw]x columns: c0=(0,pz,-py), c1=(-pz,0,px), c2=(py,-px,0)
      V3 c0 = {0, pw.z, -pw.y}, c1 = {-pw.z, 0, pw.x}, c2 = {pw.y, -pw.x, 0};
      Rp[0] = -1.0 * R->mul(c0);
      Rp[1] = -1.0 * R->mul(c1);
      Rp[2] = -1.0 * R->mul(c2);
      double Jrow_u[6], Jrow_v[6];
      for (int k = 0; k < 3; k++) {
        Jrow_u[k] = Ju[0] * Rp[k].x + Ju[1] * Rp[k].y + Ju[2] * Rp[k].z;
        Jrow_v[k] = Jv[0] * Rp[k].x + Jv[1] * Rp[k].y + Jv[2] * Rp[k].z;
      }
      Jrow_u[3] = Ju[0]; Jrow_u[4] = Ju[1]; Jrow_u[5] = Ju[2];
      Jrow_v[3] = Jv[0]; Jrow_v[4] = Jv[1]; Jrow_v[5] = Jv[2];
      for (int r = 0; r < 6; r++) {
        for (int cI = 0; cI < 6; cI++)
          JtJ[6 * r + cI] += Jrow_u[r] * Jrow_u[cI] + Jrow_v[r] * Jrow_v[cI];
        Jtr[r] += Jrow_u[r] * ru + Jrow_v[r] * rv;
      }
    }
    // LM step with simple lambda schedule.
    bool stepped = false;
    for (int tries = 0; tries < 6 && !stepped; tries++) {
      double A[36];
      std::memcpy(A, JtJ, sizeof(A));
      for (int d = 0; d < 6; d++) A[6 * d + d] += lambda * (1.0 + A[6 * d + d]);
      double b[6], dx[6];
      for (int d = 0; d < 6; d++) b[d] = -Jtr[d];
      if (chol_solve6(A, b, dx)) {
        M3 Rn = R->mulM(rodrigues({dx[0], dx[1], dx[2]}));
        V3 tn = {t->x + dx[3], t->y + dx[4], t->z + dx[5]};
        double cn = total_cost(cam, Rn, tn, p2d, p3d, n, mask);
        if (cn < cost) {
          *R = Rn;
          *t = tn;
          cost = cn;
          lambda = std::max(lambda * 0.3, 1e-9);
          stepped = true;
          break;
        }
      }
      lambda *= 10.0;
    }
    if (!stepped) break;
  }
}

// xorshift64* PRNG
struct Rng {
  uint64_t s;
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
  }
  int uniform(int n) { return (int)(next() % (uint64_t)n); }
};

}  // namespace

extern "C" {

// Returns 1 on success. R_out row-major 3x3 (world->cam), t_out 3.
int pnp_ransac(const double* pts2d, const double* pts3d, int n,
               const double* K, double ransac_thres, int max_iters,
               double confidence, uint64_t seed, int refine_iters,
               double* R_out, double* t_out, uint8_t* inlier_mask,
               int* num_inliers) {
  if (n < 4) return 0;
  Cam cam = {K[0], K[4], K[2], K[5]};
  double thr2 = ransac_thres * ransac_thres;
  Rng rng{seed ? seed : 0x9E3779B97F4A7C15ULL};

  // Precompute bearings.
  double* bear = new double[3 * n];
  for (int i = 0; i < n; i++) {
    V3 d = {(pts2d[2 * i] - cam.cx) / cam.fx, (pts2d[2 * i + 1] - cam.cy) / cam.fy,
            1.0};
    V3 f = normalize(d);
    bear[3 * i] = f.x;
    bear[3 * i + 1] = f.y;
    bear[3 * i + 2] = f.z;
  }

  M3 bestR;
  V3 bestT;
  int best_cnt = 0;
  double best_err = 1e30;
  uint8_t* mask_tmp = new uint8_t[n];
  uint8_t* mask_ref = new uint8_t[n];
  uint8_t* mask_best = new uint8_t[n];
  std::memset(mask_best, 0, n);

  int iters = max_iters;
  for (int it = 0; it < iters; it++) {
    int i0 = rng.uniform(n), i1 = rng.uniform(n), i2 = rng.uniform(n);
    if (i0 == i1 || i1 == i2 || i0 == i2) continue;
    V3 pw[3] = {{pts3d[3 * i0], pts3d[3 * i0 + 1], pts3d[3 * i0 + 2]},
                {pts3d[3 * i1], pts3d[3 * i1 + 1], pts3d[3 * i1 + 2]},
                {pts3d[3 * i2], pts3d[3 * i2 + 1], pts3d[3 * i2 + 2]}};
    V3 f[3] = {{bear[3 * i0], bear[3 * i0 + 1], bear[3 * i0 + 2]},
               {bear[3 * i1], bear[3 * i1 + 1], bear[3 * i1 + 2]},
               {bear[3 * i2], bear[3 * i2 + 1], bear[3 * i2 + 2]}};
    M3 Rs[4];
    V3 ts[4];
    int ns = p3p_grunert(pw, f, Rs, ts);
    for (int s = 0; s < ns; s++) {
      double serr;
      int cnt = count_inliers(cam, Rs[s], ts[s], pts2d, pts3d, n, thr2,
                              mask_tmp, &serr);
      if (cnt > best_cnt || (cnt == best_cnt && serr < best_err)) {
        // Local optimization (LO-RANSAC): polish on current inliers,
        // keeping the BETTER of {original, refined} — LM can push
        // borderline inliers past the threshold and must not discard a
        // candidate that already beat the current best.
        M3 R = Rs[s];
        V3 t = ts[s];
        if (cnt >= 4) {
          M3 R2 = R;
          V3 t2 = t;
          refine_lm(cam, &R2, &t2, pts2d, pts3d, n, mask_tmp, 5);
          double serr2;
          int cnt2 = count_inliers(cam, R2, t2, pts2d, pts3d, n, thr2,
                                   mask_ref, &serr2);
          if (cnt2 > cnt || (cnt2 == cnt && serr2 < serr)) {
            R = R2;
            t = t2;
            cnt = cnt2;
            serr = serr2;
            std::memcpy(mask_tmp, mask_ref, n);
          }
        }
        if (cnt > best_cnt || (cnt == best_cnt && serr < best_err)) {
          best_cnt = cnt;
          best_err = serr;
          bestR = R;
          bestT = t;
          std::memcpy(mask_best, mask_tmp, n);
          // Adaptive termination.
          double w = (double)cnt / n;
          double p3 = w * w * w;
          if (p3 > 1e-9 && p3 < 1.0) {
            double need = std::log(1.0 - confidence) / std::log(1.0 - p3);
            iters = std::min((double)max_iters, std::max(need, (double)it + 1.0));
          } else if (p3 >= 1.0) {
            iters = it + 1;
          }
        }
      }
    }
  }
  delete[] bear;
  delete[] mask_tmp;
  delete[] mask_ref;

  if (best_cnt < 4) {
    delete[] mask_best;
    return 0;
  }
  // Final refinement on inliers.
  refine_lm(cam, &bestR, &bestT, pts2d, pts3d, n, mask_best, refine_iters);
  best_cnt = count_inliers(cam, bestR, bestT, pts2d, pts3d, n, thr2, mask_best,
                           nullptr);

  std::memcpy(R_out, bestR.m, 9 * sizeof(double));
  t_out[0] = bestT.x;
  t_out[1] = bestT.y;
  t_out[2] = bestT.z;
  if (inlier_mask) std::memcpy(inlier_mask, mask_best, n);
  if (num_inliers) *num_inliers = best_cnt;
  delete[] mask_best;
  return 1;
}

// Standalone LM refinement (cv2.solvePnPRefineLM equivalent).
void pnp_refine(const double* pts2d, const double* pts3d, int n,
                const double* K, double* R_io, double* t_io, int iters) {
  Cam cam = {K[0], K[4], K[2], K[5]};
  M3 R;
  std::memcpy(R.m, R_io, 9 * sizeof(double));
  V3 t = {t_io[0], t_io[1], t_io[2]};
  refine_lm(cam, &R, &t, pts2d, pts3d, n, nullptr, iters);
  std::memcpy(R_io, R.m, 9 * sizeof(double));
  t_io[0] = t.x;
  t_io[1] = t.y;
  t_io[2] = t.z;
}

}  // extern "C"
