// Per-env physics shared by the substep kernels (fused_substep.cu: B1;
// split_substep.cu: B2 + B3): the model table, 3-vector and spatial algebra,
// forward kinematics, sphere contacts with the plane or with a held sample
// of a heightfield, joint forces, the articulated-body algorithm and
// semi-implicit integration.
//
// Everything here is __host__ __device__ plain C++ on one env's per-thread
// arrays, so it also compiles as host code (see fused_substep.cu).  The
// caps below bound those arrays; physics/fused.py and physics/fused_split.py
// gate the scenes that fit them.  Every input and output array is env-minor:
// element (k, env) at k * n + env.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FS_HD __host__ __device__
#else
#define FS_HD
#endif

#define FS_MAX_BODIES 32
#define FS_MAX_DOFS 32
#define FS_MAX_GEOMS 256
#define FS_MAX_Q 64
#define FS_MAX_V 64
#define FS_MAX_SENSORS 8   // force-sensor bodies (Ant: 4, Humanoid: 2)

enum { JT_FREE = 0, JT_REVOLUTE = 1, JT_PRISMATIC = 2, JT_FIXED = 3 };
enum { DRIVE_NONE = 0, DRIVE_POS = 1, DRIVE_VEL = 2, DRIVE_EFFORT = 3 };

// Mirrored field for field by the ctypes.Structure in physics/fused.py.
// Every member is 4 bytes wide, so the layout has no padding.
struct FusedModel {
    int nb, nq, nv, nd, ng, ns;
    int parent[FS_MAX_BODIES];
    int jtype[FS_MAX_BODIES];
    int q_adr[FS_MAX_BODIES];
    int v_adr[FS_MAX_BODIES];
    int body_dof[FS_MAX_BODIES];   // dof index of a 1-dof body, else -1
    int dof_body[FS_MAX_DOFS];
    int dof_mode[FS_MAX_DOFS];
    int dof_haslim[FS_MAX_DOFS];
    int geom_body[FS_MAX_GEOMS];
    int sensor_body[FS_MAX_SENSORS];  // bodies whose inbound joint carries a force sensor
    float R_tree[FS_MAX_BODIES][9];    // joint frame rotation, row-major
    float p_tree[FS_MAX_BODIES][3];
    float axis[FS_MAX_BODIES][3];
    float inertia[FS_MAX_BODIES][36];  // spatial inertia about the body origin
    float dof_kp[FS_MAX_DOFS];
    float dof_kd[FS_MAX_DOFS];
    float dof_lower[FS_MAX_DOFS];
    float dof_upper[FS_MAX_DOFS];
    float dof_effort[FS_MAX_DOFS];
    float dof_maxvel[FS_MAX_DOFS];
    float dof_armature[FS_MAX_DOFS];
    float dof_friction[FS_MAX_DOFS];
    float geom_off[FS_MAX_GEOMS][3];
    float geom_r[FS_MAX_GEOMS];
    float geom_mu[FS_MAX_GEOMS];
    float geom_meff[FS_MAX_GEOMS];
    float geom_meff_el[FS_MAX_GEOMS];
    float gravity[3];
    float kn, kd, kt;                  // contact stiffness, damping, tangential
    float limit_k, limit_d, fric_eps;  // engine passive-force constants
    float max_angvel, max_linvel;      // free-root velocity clamps
};

// ---------------------------------------------------------------- 3-vectors

FS_HD static inline void cross3(const float* a, const float* b, float* o) {
    float x = a[1] * b[2] - a[2] * b[1];
    float y = a[2] * b[0] - a[0] * b[2];
    float z = a[0] * b[1] - a[1] * b[0];
    o[0] = x; o[1] = y; o[2] = z;
}

FS_HD static inline void mv3(const float* R, const float* v, float* o) {  // R v
    float x = R[0] * v[0] + R[1] * v[1] + R[2] * v[2];
    float y = R[3] * v[0] + R[4] * v[1] + R[5] * v[2];
    float z = R[6] * v[0] + R[7] * v[1] + R[8] * v[2];
    o[0] = x; o[1] = y; o[2] = z;
}

FS_HD static inline void mtv3(const float* R, const float* v, float* o) {  // R^T v
    float x = R[0] * v[0] + R[3] * v[1] + R[6] * v[2];
    float y = R[1] * v[0] + R[4] * v[1] + R[7] * v[2];
    float z = R[2] * v[0] + R[5] * v[1] + R[8] * v[2];
    o[0] = x; o[1] = y; o[2] = z;
}

FS_HD static inline void mm3(const float* A, const float* B, float* o) {  // A B
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            o[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

FS_HD static inline void quat_to_R(float x, float y, float z, float w, float* R) {
    float xx = x * x, yy = y * y, zz = z * z;
    float xy = x * y, xz = x * z, yz = y * z;
    float wx = w * x, wy = w * y, wz = w * z;
    R[0] = 1.0f - 2.0f * (yy + zz); R[1] = 2.0f * (xy - wz);        R[2] = 2.0f * (xz + wy);
    R[3] = 2.0f * (xy + wz);        R[4] = 1.0f - 2.0f * (xx + zz); R[5] = 2.0f * (yz - wx);
    R[6] = 2.0f * (xz - wy);        R[7] = 2.0f * (yz + wx);        R[8] = 1.0f - 2.0f * (xx + yy);
}

// quat_apply: v + w t + u x t with t = 2 u x v
FS_HD static inline void quat_apply(const float* q, const float* v, float* o) {
    float t[3], ut[3];
    cross3(q, v, t);
    t[0] *= 2.0f; t[1] *= 2.0f; t[2] *= 2.0f;
    cross3(q, t, ut);
    for (int k = 0; k < 3; ++k) o[k] = v[k] + q[3] * t[k] + ut[k];
}

// ------------------------------------------------------------ spatial algebra

// parent-frame motion m -> child frame: [R^T w, R^T (v - p x w)]
FS_HD static inline void mot_to_child(const float* R, const float* p, const float* m, float* o) {
    float pxw[3], d[3], w[3], v[3];
    cross3(p, m, pxw);
    for (int k = 0; k < 3; ++k) d[k] = m[3 + k] - pxw[k];
    mtv3(R, m, w);
    mtv3(R, d, v);
    for (int k = 0; k < 3; ++k) { o[k] = w[k]; o[3 + k] = v[k]; }
}

// child-frame force f -> parent frame: [R n + p x (R f), R f]
FS_HD static inline void frc_to_parent(const float* R, const float* p, const float* f, float* o) {
    float lin[3], n[3], pxl[3];
    mv3(R, f + 3, lin);
    mv3(R, f, n);
    cross3(p, lin, pxl);
    for (int k = 0; k < 3; ++k) { o[k] = n[k] + pxl[k]; o[3 + k] = lin[k]; }
}

FS_HD static inline void crm(const float* v, const float* m, float* o) {  // v x m
    float a[3], b[3], c[3];
    cross3(v, m, a);
    cross3(v, m + 3, b);
    cross3(v + 3, m, c);
    for (int k = 0; k < 3; ++k) { o[k] = a[k]; o[3 + k] = b[k] + c[k]; }
}

FS_HD static inline void crf(const float* v, const float* f, float* o) {  // v x* f
    float a[3], b[3], c[3];
    cross3(v, f, a);
    cross3(v + 3, f + 3, b);
    cross3(v, f + 3, c);
    for (int k = 0; k < 3; ++k) { o[k] = a[k] + b[k]; o[3 + k] = c[k]; }
}

FS_HD static inline void mv6(const float* I, const float* v, float* o) {
    for (int r = 0; r < 6; ++r) {
        float s = 0.0f;
        for (int k = 0; k < 6; ++k) s += I[6 * r + k] * v[k];
        o[r] = s;
    }
}

// Adds inertia_to_parent(R, p, I) = Xf(c->p) I Xm(p->c) to out, through the
// 3x3 blocks: with E = R A R^T, F = R B R^T, G = R C R^T, H = R D R^T and
// px = skew(p): A' = E - F px + px G - px H px, B' = F + px H, C' = G - H px, D' = H.
FS_HD static void add_inertia_to_parent(const float* R, const float* p, const float* I, float* out) {
    float blk[4][9], tmp[9], Rt[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) Rt[3 * i + j] = R[3 * j + i];
    for (int b = 0; b < 4; ++b) {
        int r0 = (b / 2) * 3, c0 = (b % 2) * 3;
        float M[9];
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) M[3 * i + j] = I[6 * (r0 + i) + c0 + j];
        mm3(R, M, tmp);
        mm3(tmp, Rt, blk[b]);
    }
    const float *E = blk[0], *F = blk[1], *G = blk[2], *H = blk[3];
    float px[9] = {0.0f, -p[2], p[1], p[2], 0.0f, -p[0], -p[1], p[0], 0.0f};
    float pxG[9], Fpx[9], pxH[9], pxHpx[9], Hpx[9];
    mm3(px, G, pxG);
    mm3(F, px, Fpx);
    mm3(px, H, pxH);
    mm3(pxH, px, pxHpx);
    mm3(H, px, Hpx);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            int k = 3 * i + j;
            out[6 * i + j] += E[k] + pxG[k] - Fpx[k] - pxHpx[k];
            out[6 * i + 3 + j] += F[k] + pxH[k];
            out[6 * (3 + i) + j] += G[k] - Hpx[k];
            out[6 * (3 + i) + 3 + j] += H[k];
        }
}

// Solves A x = b for symmetric positive-definite 6x6 A (Cholesky).
FS_HD static void chol_solve6(const float* A, const float* b, float* x) {
    float L[36], y[6];
    for (int j = 0; j < 6; ++j) {
        float s = A[6 * j + j];
        for (int k = 0; k < j; ++k) s -= L[6 * j + k] * L[6 * j + k];
        L[6 * j + j] = sqrtf(fmaxf(s, 1e-12f));
        float inv = 1.0f / L[6 * j + j];
        for (int i = j + 1; i < 6; ++i) {
            float t = A[6 * i + j];
            for (int k = 0; k < j; ++k) t -= L[6 * i + k] * L[6 * j + k];
            L[6 * i + j] = t * inv;
        }
    }
    for (int i = 0; i < 6; ++i) {
        float s = b[i];
        for (int k = 0; k < i; ++k) s -= L[6 * i + k] * y[k];
        y[i] = s / L[6 * i + i];
    }
    for (int i = 5; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < 6; ++k) s -= L[6 * k + i] * x[k];
        x[i] = s / L[6 * i + i];
    }
}

// --------------------------------------------------------- forward kinematics

// Per-body kinematics of one env: local and world frames, body-frame spatial
// velocity, the velocity-product bias c = v x vJ, and the world angular and
// linear velocities of each body origin.
struct Kin {
    float Rl[FS_MAX_BODIES][9], pl[FS_MAX_BODIES][3];
    float Rw[FS_MAX_BODIES][9], pw[FS_MAX_BODIES][3];
    float v[FS_MAX_BODIES][6], cb[FS_MAX_BODIES][6];
    float wang[FS_MAX_BODIES][3], wlin[FS_MAX_BODIES][3];
};

FS_HD static void fk(const FusedModel& M, const float* q, const float* qd, Kin& k) {
    for (int i = 0; i < M.nb; ++i) {
        const int jt = M.jtype[i], qa = M.q_adr[i], va = M.v_adr[i];
        const float* Rt = M.R_tree[i];
        const float* pt = M.p_tree[i];
        const float* ax = M.axis[i];
        float vj[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (jt == JT_FREE) {
            float Rq[9], rp[3];
            quat_to_R(q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6], Rq);
            mm3(Rt, Rq, k.Rl[i]);
            mv3(Rt, q + qa, rp);
            for (int c = 0; c < 3; ++c) k.pl[i][c] = pt[c] + rp[c];
            for (int c = 0; c < 6; ++c) vj[c] = qd[va + c];
        } else if (jt == JT_REVOLUTE) {
            float s = sinf(q[qa]), c = cosf(q[qa]), C = 1.0f - c;
            float Rj[9] = {
                c + ax[0] * ax[0] * C, ax[0] * ax[1] * C - ax[2] * s, ax[0] * ax[2] * C + ax[1] * s,
                ax[1] * ax[0] * C + ax[2] * s, c + ax[1] * ax[1] * C, ax[1] * ax[2] * C - ax[0] * s,
                ax[2] * ax[0] * C - ax[1] * s, ax[2] * ax[1] * C + ax[0] * s, c + ax[2] * ax[2] * C};
            mm3(Rt, Rj, k.Rl[i]);
            for (int c3 = 0; c3 < 3; ++c3) { k.pl[i][c3] = pt[c3]; vj[c3] = ax[c3] * qd[va]; }
        } else if (jt == JT_PRISMATIC) {
            float d[3] = {ax[0] * q[qa], ax[1] * q[qa], ax[2] * q[qa]}, rp[3];
            mv3(Rt, d, rp);
            for (int c = 0; c < 9; ++c) k.Rl[i][c] = Rt[c];
            for (int c = 0; c < 3; ++c) { k.pl[i][c] = pt[c] + rp[c]; vj[3 + c] = ax[c] * qd[va]; }
        } else {  // JT_FIXED
            for (int c = 0; c < 9; ++c) k.Rl[i][c] = Rt[c];
            for (int c = 0; c < 3; ++c) k.pl[i][c] = pt[c];
        }
        const int par = M.parent[i];
        if (par < 0) {
            for (int c = 0; c < 9; ++c) k.Rw[i][c] = k.Rl[i][c];
            for (int c = 0; c < 3; ++c) k.pw[i][c] = k.pl[i][c];
            for (int c = 0; c < 6; ++c) k.v[i][c] = vj[c];
        } else {
            float rp[3], vp[6];
            mm3(k.Rw[par], k.Rl[i], k.Rw[i]);
            mv3(k.Rw[par], k.pl[i], rp);
            for (int c = 0; c < 3; ++c) k.pw[i][c] = k.pw[par][c] + rp[c];
            mot_to_child(k.Rl[i], k.pl[i], k.v[par], vp);
            for (int c = 0; c < 6; ++c) k.v[i][c] = vp[c] + vj[c];
        }
        crm(k.v[i], vj, k.cb[i]);
        mv3(k.Rw[i], k.v[i], k.wang[i]);
        mv3(k.Rw[i], k.v[i] + 3, k.wlin[i]);
    }
}

// ------------------------------------------------------ ground sphere contacts

// The ground under one env's geoms, env-minor like every other input.  B1's
// terrain_mode: h (ng, N) is the ground height and n (3 ng, N) the unit
// normal under each geom, sampled by the caller once per control step and
// held across its substeps; null h and n are the plane z = 0 with normal
// (0, 0, 1).  fric_mode: mu (ng, N) is each env's friction; null takes the
// table's geom_mu.  Each pointer is null or not for the whole launch, so
// every branch on it is uniform across the grid.  B2 passes all three null.
struct Ground {
    const float* h;
    const float* n;
    const float* mu;
};

// Pass 1: adds each penetrating geom to its body's live contact count.
FS_HD static void ground_count(const FusedModel& M, const Kin& k, const Ground& G, int e, int n, float* count) {
    for (int g = 0; g < M.ng; ++g) {
        const int b = M.geom_body[g];
        const float* o = M.geom_off[g];
        float oz = k.Rw[b][6] * o[0] + k.Rw[b][7] * o[1] + k.Rw[b][8] * o[2];
        const float hg = G.h ? G.h[(size_t)g * n + e] : 0.0f;
        if (hg + M.geom_r[g] - (k.pw[b][2] + oz) > 0.0f) count[b] += 1.0f;
    }
}

// Pass 2: Hunt-Crossley normal force and anchored-spring stiction of every
// geom against the ground, with each body's budget share (1 / its live
// count); accumulates world [moment, force] about the body origin into fext
// and the force into cf, and advances the slip state (3 per geom, in place).
// The normal enters the contact point (off_w - r n from the body origin),
// the normal and tangential velocities and the slip's projection onto the
// tangent plane, in the order of the JAX package's contact.contact_forces.
// probe, null or this substep's 2 ng rows (env-minor): each geom's depth
// (row g) and f_mag - f_max (row ng + g), the margins of its activation and
// of its Coulomb clamp, for a witness of decisions taken within rounding.
FS_HD static void ground_forces(const FusedModel& M, const Kin& k, const Ground& G, const float* share,
                                float* slip, int e, int n, float h, float hh,
                                float (*fext)[6], float (*cf)[3], float* probe) {
    for (int g = 0; g < M.ng; ++g) {
        const int b = M.geom_body[g];
        const float r = M.geom_r[g];
        float nv[3] = {0.0f, 0.0f, 1.0f}, off_w[3], t[3];
        if (G.n)
            for (int c = 0; c < 3; ++c) nv[c] = G.n[(size_t)(3 * g + c) * n + e];
        const float hg = G.h ? G.h[(size_t)g * n + e] : 0.0f;
        mv3(k.Rw[b], M.geom_off[g], off_w);
        const float depth = hg + r - (k.pw[b][2] + off_w[2]);
        const bool active = depth > 0.0f;
        // material velocity at the contact point, the sphere's point nearest the ground
        const float bottom[3] = {-r * nv[0], -r * nv[1], -r * nv[2]};
        float vel[3], vt[3], s[3], ft[3];
        cross3(k.wang[b], off_w, t);
        for (int c = 0; c < 3; ++c) vel[c] = k.wlin[b][c] + t[c];
        cross3(k.wang[b], bottom, t);
        for (int c = 0; c < 3; ++c) vel[c] += t[c];
        const float v_n = vel[0] * nv[0] + vel[1] * nv[1] + vel[2] * nv[2];
        for (int c = 0; c < 3; ++c) vt[c] = vel[c] - v_n * nv[c];
        const float sh = share[b];
        const float meff = M.geom_meff[g] * sh;
        const float arrest = 0.25f * M.geom_meff[g] * sh / h;
        const float arrest_n = 1.0f * M.geom_meff[g] * sh / h;  // deadbeat normal cap
        const float kn_eff = fminf(M.kn, M.geom_meff_el[g] * sh / hh);
        const float d_pos = fminf(fmaxf(depth, 0.0f), 0.05f);
        const float f_damp = fminf(M.kd * d_pos, arrest_n) * (-v_n);
        const float fn = active ? fmaxf(kn_eff * d_pos + f_damp, 0.0f) : 0.0f;
        const float kt_el = fminf(M.kt, meff / hh);
        const float ct = fminf(arrest, M.kt);
        // anchored-spring stiction on the tangent plane, projected onto the Coulomb cone
        float* sp = slip + (size_t)(3 * g) * n + e;
        for (int c = 0; c < 3; ++c) s[c] = sp[(size_t)c * n] + vt[c] * h;
        const float s_n = s[0] * nv[0] + s[1] * nv[1] + s[2] * nv[2];
        for (int c = 0; c < 3; ++c) s[c] = s[c] - s_n * nv[c];
        for (int c = 0; c < 3; ++c) ft[c] = -kt_el * s[c] - ct * vt[c];
        const float f_mag = sqrtf(ft[0] * ft[0] + ft[1] * ft[1] + ft[2] * ft[2]);
        const float mu = G.mu ? G.mu[(size_t)g * n + e] : M.geom_mu[g];
        const float f_max = mu * fn;
        const bool clamp = f_mag > f_max;
        const float scale = clamp ? f_max / fmaxf(f_mag, 1e-9f) : 1.0f;
        const float kdiv = fmaxf(kt_el, 1e-9f);
        float fw[3], lever[3], tq[3];
        for (int c = 0; c < 3; ++c) {
            const float f = ft[c] * scale;
            sp[(size_t)c * n] = active ? (clamp ? -f / kdiv : s[c]) : 0.0f;
            fw[c] = fn * nv[c] + (active ? f : 0.0f);
            lever[c] = off_w[c] + bottom[c];
        }
        cross3(lever, fw, tq);
        for (int c = 0; c < 3; ++c) {
            fext[b][c] += tq[c];
            fext[b][3 + c] += fw[c];
            cf[b][c] += fw[c];
        }
        if (probe) {
            probe[(size_t)g * n + e] = depth;
            probe[(size_t)(M.ng + g) * n + e] = f_mag - f_max;
        }
    }
}

// ------------------------------------------------------------- world anchors

// One world anchor (contact.anchor_forces): the point `off` (body frame) of a
// body at pose (R, p) with world velocities (wang, wlin) of its origin, held
// at the world point `target` by the stiffest spring-damper stable at the
// substep h (Baumgarte): f = -(0.2 m / h^2) d - (0.7 m / h) v with m the
// anchor's effective mass.  Adds world [moment, force] about the body origin
// to fext6.  Shared by the kernels that take anchors (B2 now).
FS_HD static inline void anchor_force(const float* R, const float* p, const float* wang, const float* wlin,
                                      const float* off, const float* target, float m, float h, float hh,
                                      float* fext6) {
    float lever[3], w[3], f[3], tq[3];
    mv3(R, off, lever);
    cross3(wang, lever, w);
    const float kp = 0.2f * m / hh, kd = 0.7f * m / h;
    for (int c = 0; c < 3; ++c) f[c] = -kp * ((p[c] + lever[c]) - target[c]) - kd * (wlin[c] + w[c]);
    cross3(lever, f, tq);
    for (int c = 0; c < 3; ++c) {
        fext6[c] += tq[c];
        fext6[3 + c] += f[c];
    }
}

// ----------------------------------------------------------------- joint forces

// Drive force (clamped to the effort limit) plus the passive limit spring,
// joint friction and drive-less damping per dof into tau; the backward-Euler
// diagonal h*Kd + h^2*Kp of those spring-dampers into dextra.
FS_HD static void joint_forces(const FusedModel& M, const float* q, const float* qd,
                               const float* pos_target, const float* vel_target, const float* effort,
                               int e, int n, float h, float hh, float* tau, float* dextra) {
    for (int d = 0; d < M.nd; ++d) {
        const int b = M.dof_body[d], mode = M.dof_mode[d];
        const float dp = q[M.q_adr[b]], dv = qd[M.v_adr[b]];
        const float kp = M.dof_kp[d], kd = M.dof_kd[d];
        float ta = 0.0f;
        if (mode == DRIVE_POS) ta = kp * (pos_target[(size_t)d * n + e] - dp) - kd * dv;
        else if (mode == DRIVE_VEL) ta = kd * (vel_target[(size_t)d * n + e] - dv);
        else if (mode == DRIVE_EFFORT) ta = effort[(size_t)d * n + e];
        ta = fminf(fmaxf(ta, -M.dof_effort[d]), M.dof_effort[d]);
        float tp = 0.0f, at = 0.0f;
        if (M.dof_haslim[d]) {
            const float below = fminf(dp - M.dof_lower[d], 0.0f);
            const float above = fmaxf(dp - M.dof_upper[d], 0.0f);
            at = (below < 0.0f || above > 0.0f) ? 1.0f : 0.0f;
            tp = -M.limit_k * (below + above) - M.limit_d * dv * at;
        }
        tp = tp + (-M.dof_friction[d] * tanhf(dv / M.fric_eps));
        if (mode == DRIVE_NONE || mode == DRIVE_EFFORT) tp = tp + (-kd * dv);
        tau[d] = ta + tp;
        const float kp_imp = (mode == DRIVE_POS ? kp : 0.0f) + M.limit_k * at;
        const float kd_imp = kd + M.limit_d * at + M.dof_friction[d] / M.fric_eps;
        dextra[d] = h * kd_imp + hh * kp_imp;
    }
}

// ------------------------------------------------------------------------ ABA

// Joint accelerations qdd (nv) from the joint forces tau (nd), the implicit
// diagonal dextra (nd) and the world external wrenches fext (per body,
// [moment, force] about the body origin).  Free joints only at roots.
// wrench, null or 6 ns floats: each sensor body's inbound joint wrench
// fj = IA a + pA (IA before the body's own joint reduction, pA with its
// children's), body frame, written [force(3), torque(3)].
FS_HD static void aba(const FusedModel& M, const Kin& k, const float* tau, const float* dextra,
                      const float (*fext)[6], float* qdd, float* wrench) {
    const int nb = M.nb;
    float IA[FS_MAX_BODIES][36], pA[FS_MAX_BODIES][6];
    float U[FS_MAX_BODIES][6], dinv[FS_MAX_BODIES], uu[FS_MAX_BODIES];
    float acc[FS_MAX_BODIES][6];

    // articulated inertias, inward
    for (int i = 0; i < nb; ++i) {
        float Iv[6], bias[6], nb_[3], fb_[3];
        for (int c = 0; c < 36; ++c) IA[i][c] = M.inertia[i][c];
        mv6(IA[i], k.v[i], Iv);
        crf(k.v[i], Iv, bias);
        mtv3(k.Rw[i], fext[i], nb_);
        mtv3(k.Rw[i], fext[i] + 3, fb_);
        for (int c = 0; c < 3; ++c) {
            pA[i][c] = bias[c] - nb_[c];
            pA[i][3 + c] = bias[3 + c] - fb_[c];
        }
    }
    for (int i = nb - 1; i >= 0; --i) {
        const int jt = M.jtype[i], par = M.parent[i];
        if (jt == JT_FREE) continue;  // roots only (gate), never propagates
        float Ic[6], pa[6];
        if (jt != JT_FIXED) {
            const int d = M.body_dof[i];
            float S[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            const int off = (jt == JT_REVOLUTE) ? 0 : 3;
            for (int c = 0; c < 3; ++c) S[off + c] = M.axis[i][c];
            mv6(IA[i], S, U[i]);
            float di = 0.0f, sp = 0.0f;
            for (int c = 0; c < 6; ++c) { di += S[c] * U[i][c]; sp += S[c] * pA[i][c]; }
            di = di + (M.dof_armature[d] + dextra[d]);
            uu[i] = tau[d] - sp;
            dinv[i] = 1.0f / di;
            for (int r = 0; r < 6; ++r)
                for (int c = 0; c < 6; ++c) IA[i][6 * r + c] -= U[i][r] * U[i][c] * dinv[i];
        }
        mv6(IA[i], k.cb[i], Ic);
        for (int c = 0; c < 6; ++c) pa[c] = pA[i][c] + Ic[c];
        if (jt != JT_FIXED)
            for (int c = 0; c < 6; ++c) pa[c] += U[i][c] * (uu[i] * dinv[i]);
        if (par >= 0) {
            float pp[6];
            add_inertia_to_parent(k.Rl[i], k.pl[i], IA[i], IA[par]);
            frc_to_parent(k.Rl[i], k.pl[i], pa, pp);
            for (int c = 0; c < 6; ++c) pA[par][c] += pp[c];
        }
    }

    // accelerations, outward
    const float g6[6] = {0.0f, 0.0f, 0.0f, -M.gravity[0], -M.gravity[1], -M.gravity[2]};
    for (int c = 0; c < M.nv; ++c) qdd[c] = 0.0f;
    for (int i = 0; i < nb; ++i) {
        const int jt = M.jtype[i], par = M.parent[i], va = M.v_adr[i];
        float ap[6];
        if (par < 0) mot_to_child(k.Rw[i], k.pw[i], g6, ap);
        else mot_to_child(k.Rl[i], k.pl[i], acc[par], ap);
        for (int c = 0; c < 6; ++c) ap[c] += k.cb[i][c];
        if (jt == JT_FREE) {
            float Ia[6], rhs[6], sol[6];
            mv6(IA[i], ap, Ia);
            for (int c = 0; c < 6; ++c) rhs[c] = -(pA[i][c] + Ia[c]);
            chol_solve6(IA[i], rhs, sol);
            for (int c = 0; c < 6; ++c) { qdd[va + c] = sol[c]; acc[i][c] = ap[c] + sol[c]; }
        } else if (jt == JT_FIXED) {
            for (int c = 0; c < 6; ++c) acc[i][c] = ap[c];
        } else {
            float Ua = 0.0f;
            for (int c = 0; c < 6; ++c) Ua += U[i][c] * ap[c];
            const float qi = (uu[i] - Ua) * dinv[i];
            qdd[va] = qi;
            const int off = (jt == JT_REVOLUTE) ? 0 : 3;
            for (int c = 0; c < 6; ++c) acc[i][c] = ap[c];
            for (int c = 0; c < 3; ++c) acc[i][off + c] += M.axis[i][c] * qi;
        }
    }

    // force sensors.  The inward pass reduced a 1-dof body's IA in place to
    // Ia = IA - U U^T / d, so IA a = Ia a + U (U^T a) / d; fixed and free
    // bodies are never reduced.
    if (!wrench) return;
    for (int s = 0; s < M.ns; ++s) {
        const int b = M.sensor_body[s], jt = M.jtype[b];
        float fj[6];
        mv6(IA[b], acc[b], fj);
        if (jt == JT_REVOLUTE || jt == JT_PRISMATIC) {
            float Ua = 0.0f;
            for (int c = 0; c < 6; ++c) Ua += U[b][c] * acc[b][c];
            for (int c = 0; c < 6; ++c) fj[c] += U[b][c] * (Ua * dinv[b]);
        }
        for (int c = 0; c < 3; ++c) {
            wrench[6 * s + c] = fj[3 + c] + pA[b][3 + c];
            wrench[6 * s + 3 + c] = fj[c] + pA[b][c];
        }
    }
}

// ------------------------------------------------------------------ integrate

// Semi-implicit Euler: qd += qdd h with the dof and free-root velocity
// clamps, then q from the new qd (free roots by the quaternion exp map).
FS_HD static void integrate(const FusedModel& M, float* q, float* qd, const float* qdd, float h) {
    for (int c = 0; c < M.nv; ++c) qd[c] = qd[c] + qdd[c] * h;
    for (int d = 0; d < M.nd; ++d) {
        const int va = M.v_adr[M.dof_body[d]];
        qd[va] = fminf(fmaxf(qd[va], -M.dof_maxvel[d]), M.dof_maxvel[d]);
    }
    for (int b = 0; b < M.nb; ++b) {
        if (M.jtype[b] != JT_FREE) continue;
        const int qa = M.q_adr[b], va = M.v_adr[b];
        for (int c = 0; c < 3; ++c) {
            qd[va + c] = fminf(fmaxf(qd[va + c], -M.max_angvel), M.max_angvel);
            qd[va + 3 + c] = fminf(fmaxf(qd[va + 3 + c], -M.max_linvel), M.max_linvel);
        }
        const float quat[4] = {q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6]};
        float om[3], vw[3];
        quat_apply(quat, qd + va, om);
        quat_apply(quat, qd + va + 3, vw);
        for (int c = 0; c < 3; ++c) q[qa + c] = q[qa + c] + vw[c] * h;
        // exp-map quaternion update: dq = [omega k, cos(half)], q' = unit(dq q)
        const float ang = sqrtf(om[0] * om[0] + om[1] * om[1] + om[2] * om[2]);
        const float half = 0.5f * ang * h;
        const float kf = ang > 1e-9f ? sinf(half) / fmaxf(ang, 1e-9f) : 0.5f * h;
        const float x1 = om[0] * kf, y1 = om[1] * kf, z1 = om[2] * kf, w1 = cosf(half);
        const float x2 = quat[0], y2 = quat[1], z2 = quat[2], w2 = quat[3];
        const float qx = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
        const float qy = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
        const float qz = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
        const float qw = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
        const float nrm = fmaxf(sqrtf(qx * qx + qy * qy + qz * qz + qw * qw), 1e-9f);
        q[qa + 3] = qx / nrm; q[qa + 4] = qy / nrm; q[qa + 5] = qz / nrm; q[qa + 6] = qw / nrm;
    }
    for (int d = 0; d < M.nd; ++d) {
        const int b = M.dof_body[d];
        q[M.q_adr[b]] = q[M.q_adr[b]] + qd[M.v_adr[b]] * h;
    }
}
