// Host-side batched energy/force server for the ALDP classical potential: the
// port's own copy of the repository's C++ energy server (same functional forms,
// same extern "C" surface), bound with ctypes by fab_tpu_torch/native/__init__.py.
//
// The reference fans batched Boltzmann-energy evaluation across a CPU thread pool
// (OpenMM through boltzgen). Here parameter tables are injected once from Python
// (fab_tpu_torch/targets/aldp_ff.py builds them, so the torch force field and this
// server share one parameter source), then batches of configurations are evaluated,
// energy and force, in parallel with std::thread.
//
// Functional forms (AMBER-type): E = sum k_b (r - r0)^2 + sum k_a (theta - t0)^2
//   + sum k_t (1 + cos(n phi - phase)) + sum qq/r + eps((rmin/r)^12 - 2 (rmin/r)^6)
// with analytic forces for every term.
//
// Build (fab_tpu_torch/ops/build.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 aldp_energy.cpp -o libaldp_energy.so -lpthread
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Tables {
  int n_atoms = 0;
  std::vector<int> bond_idx;  // [NB*2]
  std::vector<double> bond_k, bond_r0;
  std::vector<int> angle_idx;  // [NA*3]
  std::vector<double> angle_k, angle_t0;
  std::vector<int> torsion_idx;  // [NT*4]
  std::vector<double> torsion_k, torsion_phase;
  std::vector<int> torsion_n;
  std::vector<int> pair_idx;  // [NP*2]
  std::vector<double> pair_qq, pair_eps, pair_rmin;
  int n_threads = 1;
};

Tables g_tables;

// GBSA-OBC2 implicit-solvent tables (aldp_gb_init). Parameters are injected from
// fab_tpu_torch/targets/aldp_ff.py so the C++ server and the torch force field share one source of
// truth; functional forms follow OpenMM's reference GBSA-OBC implementation
// (ReferenceObc::computeBornRadii / computeBornEnergyForces), matching
// fab_tpu_torch/targets/aldp_ff.py born_radii/gb_energy_kcal.
struct GbTables {
  bool enabled = false;
  int n = 0;
  std::vector<double> q;       // partial charges [e]
  std::vector<double> radius;  // intrinsic (mbondi2) radii [A]
  std::vector<double> rho;     // offset radii = radius - offset
  std::vector<double> sr;      // scaled descreening radii = scale * rho
  double coulomb = 0.0;        // Coulomb constant [kcal/mol A e^-2]
  double pre = 0.0;            // -0.5 C (1/eps_solute - 1/eps_solvent)
  double probe = 1.4;          // solvent probe radius [A]
  double sa_factor = 0.0;      // ACE surface-area prefactor [kcal/mol/A^2]
  double alpha = 1.0, beta = 0.8, gamma = 4.85;  // OBC2
};

GbTables g_gb;

inline void sub3(const double* a, const double* b, double* out) {
  out[0] = a[0] - b[0];
  out[1] = a[1] - b[1];
  out[2] = a[2] - b[2];
}
inline double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
inline void cross3(const double* a, const double* b, double* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}
inline double norm3(const double* a) { return std::sqrt(dot3(a, a)); }

double gb_energy_one(const double* pos, double* f);

// Energy + force of one configuration. pos: [n_atoms*3]; force accumulated
// (negative gradient) into f if non-null.
double energy_one(const double* pos, double* f) {
  const Tables& t = g_tables;
  double e = 0.0;

  // Bonds.
  for (size_t b = 0; b < t.bond_k.size(); ++b) {
    const double* pi = pos + 3 * t.bond_idx[2 * b];
    const double* pj = pos + 3 * t.bond_idx[2 * b + 1];
    double d[3];
    sub3(pi, pj, d);
    double r = norm3(d);
    double dr = r - t.bond_r0[b];
    e += t.bond_k[b] * dr * dr;
    if (f) {
      double coef = -2.0 * t.bond_k[b] * dr / r;
      for (int c = 0; c < 3; ++c) {
        f[3 * t.bond_idx[2 * b] + c] += coef * d[c];
        f[3 * t.bond_idx[2 * b + 1] + c] -= coef * d[c];
      }
    }
  }

  // Angles: E = k (theta - t0)^2.
  for (size_t a = 0; a < t.angle_k.size(); ++a) {
    int i = t.angle_idx[3 * a], j = t.angle_idx[3 * a + 1], k = t.angle_idx[3 * a + 2];
    double u[3], v[3];
    sub3(pos + 3 * i, pos + 3 * j, u);
    sub3(pos + 3 * k, pos + 3 * j, v);
    double nu = norm3(u), nv = norm3(v);
    double cosv = dot3(u, v) / (nu * nv);
    cosv = cosv > 1.0 ? 1.0 : (cosv < -1.0 ? -1.0 : cosv);
    double theta = std::acos(cosv);
    double dt = theta - t.angle_t0[a];
    e += t.angle_k[a] * dt * dt;
    if (f) {
      double sinv = std::sqrt(1.0 - cosv * cosv);
      if (sinv < 1e-8) sinv = 1e-8;
      double dEdt = 2.0 * t.angle_k[a] * dt;
      // d theta / d u = (cos * u/|u| - v/|v|) / (|u| sin), likewise for v.
      for (int c = 0; c < 3; ++c) {
        double du = (cosv * u[c] / nu - v[c] / nv) / (nu * sinv);
        double dv = (cosv * v[c] / nv - u[c] / nu) / (nv * sinv);
        f[3 * i + c] -= dEdt * du;
        f[3 * k + c] -= dEdt * dv;
        f[3 * j + c] += dEdt * (du + dv);
      }
    }
  }

  // Torsions: E = k (1 + cos(n phi - phase)); standard analytic gradient.
  for (size_t d = 0; d < t.torsion_k.size(); ++d) {
    int i = t.torsion_idx[4 * d], j = t.torsion_idx[4 * d + 1];
    int k = t.torsion_idx[4 * d + 2], l = t.torsion_idx[4 * d + 3];
    double b1[3], b2[3], b3[3];
    sub3(pos + 3 * j, pos + 3 * i, b1);
    sub3(pos + 3 * k, pos + 3 * j, b2);
    sub3(pos + 3 * l, pos + 3 * k, b3);
    double n1[3], n2[3];
    cross3(b1, b2, n1);
    cross3(b2, b3, n2);
    double nb2 = norm3(b2);
    double m1[3];
    cross3(n1, b2, m1);
    double x = dot3(n1, n2) * nb2;
    double y = dot3(m1, n2);
    double phi = std::atan2(y, x);
    // Match the torch dihedral convention (internal_coords.dihedral_angle computes
    // the same atan2 with b1 = p1 - p0 etc.; sign checked in tests).
    double arg = t.torsion_n[d] * phi - t.torsion_phase[d];
    e += t.torsion_k[d] * (1.0 + std::cos(arg));
    if (f) {
      double dEdphi = -t.torsion_k[d] * t.torsion_n[d] * std::sin(arg);
      double n1sq = dot3(n1, n1), n2sq = dot3(n2, n2);
      if (n1sq < 1e-12) n1sq = 1e-12;
      if (n2sq < 1e-12) n2sq = 1e-12;
      // Exact gradients for OUR phi convention (validated against autodiff):
      //   dphi/dri = +|b2|/|n1|^2 n1,   dphi/drl = -|b2|/|n2|^2 n2,
      //   dphi/drj = (-1 - s12) dphi/dri + s32 dphi/drl,
      //   dphi/drk = s12 dphi/dri + (-1 - s32) dphi/drl,
      // with s12 = b1.b2/|b2|^2, s32 = b3.b2/|b2|^2 (gradients sum to zero).
      double gi[3], gl[3];
      for (int c = 0; c < 3; ++c) {
        gi[c] = nb2 / n1sq * n1[c];
        gl[c] = -nb2 / n2sq * n2[c];
      }
      double s12 = dot3(b1, b2) / (nb2 * nb2);
      double s32 = dot3(b3, b2) / (nb2 * nb2);
      for (int c = 0; c < 3; ++c) {
        double gj = (-1.0 - s12) * gi[c] + s32 * gl[c];
        double gk = s12 * gi[c] + (-1.0 - s32) * gl[c];
        f[3 * i + c] -= dEdphi * gi[c];
        f[3 * j + c] -= dEdphi * gj;
        f[3 * k + c] -= dEdphi * gk;
        f[3 * l + c] -= dEdphi * gl[c];
      }
    }
  }

  // Nonbonded pairs (Coulomb + 12-6 LJ with pre-scaled parameters).
  for (size_t p = 0; p < t.pair_qq.size(); ++p) {
    int i = t.pair_idx[2 * p], j = t.pair_idx[2 * p + 1];
    double d[3];
    sub3(pos + 3 * i, pos + 3 * j, d);
    double r2 = dot3(d, d);
    double r = std::sqrt(r2);
    double inv = 1.0 / r;
    double e_c = t.pair_qq[p] * inv;
    double x2 = t.pair_rmin[p] * t.pair_rmin[p] / r2;
    double x6 = x2 * x2 * x2;
    double e_lj = t.pair_eps[p] * (x6 * x6 - 2.0 * x6);
    e += e_c + e_lj;  // (GB term, if enabled, is added after this loop)
    if (f) {
      // dE/dr: coulomb -qq/r^2; LJ: eps*(-12 x12 + 12 x6)/r.
      double dEdr = -e_c * inv + t.pair_eps[p] * (-12.0 * x6 * x6 + 12.0 * x6) * inv;
      double coef = -dEdr * inv;  // force on i along +d
      for (int c = 0; c < 3; ++c) {
        f[3 * i + c] += coef * d[c];
        f[3 * j + c] -= coef * d[c];
      }
    }
  }
  if (g_gb.enabled) e += gb_energy_one(pos, f);
  return e;
}

// HCT pairwise descreening integral term (aldp_ff.py born_radii) and its
// d/d(distance). Atom j's descreening sphere (radius sr_j) seen from atom i
// (offset radius rho_i) at distance d; caller checks activity rho_i < d + sr_j.
inline double hct_term(double d, double rho_i, double sr_j, double* ddist) {
  double U = 1.0 / (d + sr_j);
  double ad = std::fabs(d - sr_j);
  bool clamped = rho_i >= ad;  // lower bound hits 1/rho_i (j overlaps i's core)
  double L = 1.0 / (clamped ? rho_i : ad);
  double dU = -U * U;
  double dL = clamped ? 0.0 : -L * L * (d > sr_j ? 1.0 : -1.0);
  double U2 = U * U, L2 = L * L;
  double sr2 = sr_j * sr_j;
  double term = L - U + 0.25 * d * (U2 - L2) + (0.5 / d) * std::log(U / L) +
                (0.25 * sr2 / d) * (L2 - U2);
  double dterm = dL - dU + 0.25 * (U2 - L2) + 0.5 * d * (U * dU - L * dL) -
                 (0.5 / (d * d)) * std::log(U / L) +
                 (0.5 / d) * (dU / U - dL / L) -
                 (0.25 * sr2 / (d * d)) * (L2 - U2) +
                 (0.5 * sr2 / d) * (L * dL - U * dU);
  if (rho_i < sr_j - d) {  // atom i fully inside j's descreening sphere
    term += 2.0 * (1.0 / rho_i - L);
    dterm += -2.0 * dL;
  }
  *ddist = dterm;
  return term;
}

// GBSA-OBC2 energy (+ analytic forces into f) for one configuration.
double gb_energy_one(const double* pos, double* f) {
  const GbTables& g = g_gb;
  const int n = g.n;
  // Distances.
  std::vector<double> d(n * n, 0.0), d2v(n * n, 0.0);
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j) {
      double dd[3];
      sub3(pos + 3 * i, pos + 3 * j, dd);
      double r2 = dot3(dd, dd);
      d2v[i * n + j] = d2v[j * n + i] = r2;
      d[i * n + j] = d[j * n + i] = std::sqrt(r2);
    }

  // Born radii + the d(term)/d(distance) table for the chain rule.
  std::vector<double> born(n), dRb_dI(n), dterm(n * n, 0.0);
  for (int i = 0; i < n; ++i) {
    double I = 0.0;
    for (int j = 0; j < n; ++j) {
      if (j == i) continue;
      double dij = d[i * n + j];
      if (g.rho[i] >= dij + g.sr[j]) continue;  // inactive pair
      double dt;
      I += hct_term(dij, g.rho[i], g.sr[j], &dt);
      dterm[i * n + j] = dt;
    }
    double psi = 0.5 * I * g.rho[i];
    double Phi = g.alpha * psi - g.beta * psi * psi + g.gamma * psi * psi * psi;
    double th = std::tanh(Phi);
    double born_inv = 1.0 / g.rho[i] - th / g.radius[i];
    born[i] = 1.0 / born_inv;
    // dRb/dI = Rb^2 sech^2(Phi)/radius * dPhi/dpsi * 0.5 rho.
    double dPhi = g.alpha - 2.0 * g.beta * psi + 3.0 * g.gamma * psi * psi;
    dRb_dI[i] = born[i] * born[i] * (1.0 - th * th) / g.radius[i] * dPhi * 0.5 *
                g.rho[i];
  }

  // Still-equation polar term over ALL ordered pairs incl. diagonal (aldp_ff.py
  // gb_energy_kcal): E = pre sum_ij q_i q_j / f_ij, f_ii = Rb_i.
  std::vector<double> dE_dRb(n, 0.0);
  double e = 0.0;
  for (int i = 0; i < n; ++i) {
    double e_self = g.pre * g.q[i] * g.q[i] / born[i];
    e += e_self;
    dE_dRb[i] += -e_self / born[i];
  }
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j) {
      double B = born[i] * born[j];
      double x = d2v[i * n + j];
      double expo = std::exp(-x / (4.0 * B));
      double f2 = x + B * expo;
      double fg = std::sqrt(f2);
      double e_pair = 2.0 * g.pre * g.q[i] * g.q[j] / fg;  // (i,j) + (j,i)
      e += e_pair;
      double dE_df = -e_pair / fg;
      double df_dd2 = (1.0 - 0.25 * expo) / (2.0 * fg);
      double df_dB = expo * (1.0 + x / (4.0 * B)) / (2.0 * fg);
      dE_dRb[i] += dE_df * df_dB * born[j];
      dE_dRb[j] += dE_df * df_dB * born[i];
      if (f) {
        double dE_dd2 = dE_df * df_dd2;
        for (int c = 0; c < 3; ++c) {
          double g_c = dE_dd2 * 2.0 * (pos[3 * i + c] - pos[3 * j + c]);
          f[3 * i + c] -= g_c;
          f[3 * j + c] += g_c;
        }
      }
    }

  // ACE nonpolar surface-area term.
  for (int i = 0; i < n; ++i) {
    double rp = g.radius[i] + g.probe;
    double ratio = g.radius[i] / born[i];
    double r6 = ratio * ratio * ratio;
    r6 *= r6;
    double e_sa = g.sa_factor * rp * rp * r6;
    e += e_sa;
    dE_dRb[i] += -6.0 * e_sa / born[i];
  }

  // Chain the Born-radius dependence back to positions:
  // dE/dr_k via I_i = sum_j term(d_ij; rho_i, sr_j).
  if (f) {
    for (int i = 0; i < n; ++i) {
      double w_i = dE_dRb[i] * dRb_dI[i];
      if (w_i == 0.0) continue;
      for (int j = 0; j < n; ++j) {
        if (j == i || dterm[i * n + j] == 0.0) continue;
        double dij = d[i * n + j];
        double coef = w_i * dterm[i * n + j] / dij;
        for (int c = 0; c < 3; ++c) {
          double g_c = coef * (pos[3 * i + c] - pos[3 * j + c]);
          f[3 * i + c] -= g_c;
          f[3 * j + c] += g_c;
        }
      }
    }
  }
  return e;
}

}  // namespace

extern "C" {

void aldp_ff_init(int n_atoms, int n_bonds, const int* bond_idx,
                  const double* bond_k, const double* bond_r0, int n_angles,
                  const int* angle_idx, const double* angle_k,
                  const double* angle_t0, int n_torsions, const int* torsion_idx,
                  const double* torsion_k, const int* torsion_n,
                  const double* torsion_phase, int n_pairs, const int* pair_idx,
                  const double* pair_qq, const double* pair_eps,
                  const double* pair_rmin, int n_threads) {
  Tables t;
  t.n_atoms = n_atoms;
  t.bond_idx.assign(bond_idx, bond_idx + 2 * n_bonds);
  t.bond_k.assign(bond_k, bond_k + n_bonds);
  t.bond_r0.assign(bond_r0, bond_r0 + n_bonds);
  t.angle_idx.assign(angle_idx, angle_idx + 3 * n_angles);
  t.angle_k.assign(angle_k, angle_k + n_angles);
  t.angle_t0.assign(angle_t0, angle_t0 + n_angles);
  t.torsion_idx.assign(torsion_idx, torsion_idx + 4 * n_torsions);
  t.torsion_k.assign(torsion_k, torsion_k + n_torsions);
  t.torsion_n.assign(torsion_n, torsion_n + n_torsions);
  t.torsion_phase.assign(torsion_phase, torsion_phase + n_torsions);
  t.pair_idx.assign(pair_idx, pair_idx + 2 * n_pairs);
  t.pair_qq.assign(pair_qq, pair_qq + n_pairs);
  t.pair_eps.assign(pair_eps, pair_eps + n_pairs);
  t.pair_rmin.assign(pair_rmin, pair_rmin + n_pairs);
  t.n_threads = n_threads > 0 ? n_threads : 1;
  g_tables = std::move(t);
}

// Enable the GBSA-OBC2 implicit-solvent term (parameters from
// fab_tpu_torch/targets/aldp_ff.py; enabled=0 turns it back off).
void aldp_gb_init(int n_atoms, const double* charges, const double* radius,
                  const double* scale, double dielectric_offset,
                  double coulomb_const, double solute_dielectric,
                  double solvent_dielectric, double probe_radius,
                  double sa_factor, double alpha, double beta, double gamma,
                  int enabled) {
  GbTables g;
  g.enabled = enabled != 0;
  g.n = n_atoms;
  g.q.assign(charges, charges + n_atoms);
  g.radius.assign(radius, radius + n_atoms);
  g.rho.resize(n_atoms);
  g.sr.resize(n_atoms);
  for (int i = 0; i < n_atoms; ++i) {
    g.rho[i] = radius[i] - dielectric_offset;
    g.sr[i] = scale[i] * g.rho[i];
  }
  g.coulomb = coulomb_const;
  g.pre = -0.5 * coulomb_const *
          (1.0 / solute_dielectric - 1.0 / solvent_dielectric);
  g.probe = probe_radius;
  g.sa_factor = sa_factor;
  g.alpha = alpha;
  g.beta = beta;
  g.gamma = gamma;
  g_gb = std::move(g);
}

// pos: [batch, n_atoms*3]; energy_out: [batch]; force_out: [batch, n_atoms*3] or
// nullptr. Batch is chunked across the thread pool.
void aldp_energy_batch(const double* pos, int batch, double* energy_out,
                       double* force_out) {
  const int dim = 3 * g_tables.n_atoms;
  int n_threads = g_tables.n_threads;
  if (n_threads > batch) n_threads = batch;
  if (n_threads <= 1) {
    for (int b = 0; b < batch; ++b) {
      double* f = force_out ? force_out + b * dim : nullptr;
      if (f) std::memset(f, 0, sizeof(double) * dim);
      energy_out[b] = energy_one(pos + b * dim, f);
    }
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int w = 0; w < n_threads; ++w) {
    workers.emplace_back([=]() {
      for (int b = w; b < batch; b += n_threads) {
        double* f = force_out ? force_out + b * dim : nullptr;
        if (f) std::memset(f, 0, sizeof(double) * dim);
        energy_out[b] = energy_one(pos + b * dim, f);
      }
    });
  }
  for (auto& th : workers) th.join();
}

// A CUDA host function (cuLaunchHostFunc's CUhostFn): one batch through
// aldp_energy_batch, its buffers named by an AldpHostArgs. A compiled program
// enqueues it between a device -> pinned copy of the positions and pinned -> device
// copies of the energy and force (fab_tpu_torch/native/__init__.py, HostCalls); it
// makes no CUDA call, as a host node must not.
struct AldpHostArgs {
  const double* pos;  // [batch, n_atoms*3]
  double* energy;     // [batch]
  double* force;      // [batch, n_atoms*3] or nullptr
  int batch;
};

void aldp_energy_host_fn(void* args) {
  const AldpHostArgs* a = static_cast<const AldpHostArgs*>(args);
  aldp_energy_batch(a->pos, a->batch, a->energy, a->force);
}

}  // extern "C"
