// Fused physics substep loop for Hopper (sm_90a): one thread per env.
//
// Replaces the TPU kernel isaacgymenv_tpu/physics/fused.py:build_fused_substep
// for the scenes that isaacgymenv_tpu_torch/physics/fused.py:fused_structural_ok
// accepts: free roots + revolute/prismatic/fixed joints, DRIVE_* dof drives
// with limits/friction/armature, sphere contacts against the flat ground
// plane with the stiction slip carry, no pairs/anchors/tendons/sensors.
// Each thread runs all `substeps` iterations of one control step for its env:
// FK -> ground contacts (two passes: live per-body counts, then forces) ->
// drive/passive forces + implicit diagonal -> ABA -> velocity clamps and
// semi-implicit integration.  The last substep's dof force and contact
// force/torque are written out; the caller refreshes the body caches.
//
// Unlike the Pallas kernel, which unrolls the model into code at trace time,
// this is one fixed source: the model arrives as data (struct FusedModel,
// filled by the Python wrapper) and the caps below bound the per-thread
// arrays.  One build serves every model under the caps.
//
// Layout: every input and output is env-minor, element (k, env) at
// k * n + env, so neighbouring threads touch neighbouring addresses.  q, qd
// and the ground slip state are updated in place.
//
// What bounds it: the work per env is a long serial chain (~35k fp32
// operations per substep for Anymal, as chip_smoke.fused_substep_flops
// counts them) against ~4 KB of I/O per env, so the
// operation side bounds it on paper; with one thread per env, 4096 envs are
// 128 warps on 132 SMs, so the kernel is latency-bound far above that bound.
// This simple design does nothing about that: per-body state (poses,
// velocities, 6x6 articulated inertias) lives in per-thread local arrays,
// the model is read from global memory (uniform across a warp, so served by
// broadcast from cache), and the slip state is streamed from device memory
// per geom.  Occupancy, shared memory and warp-per-env are later work.
//
// The per-env body is __host__ __device__ plain C++ so it also compiles as
// host code; only the __global__ kernel and the launch function need nvcc.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: it changes sqrt/division
//        rounding against the plain version).

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

enum { JT_FREE = 0, JT_REVOLUTE = 1, JT_PRISMATIC = 2, JT_FIXED = 3 };
enum { DRIVE_NONE = 0, DRIVE_POS = 1, DRIVE_VEL = 2, DRIVE_EFFORT = 3 };

// Mirrored field for field by the ctypes.Structure in physics/fused.py.
// Every member is 4 bytes wide, so the layout has no padding.
struct FusedModel {
    int nb, nq, nv, nd, ng;
    int parent[FS_MAX_BODIES];
    int jtype[FS_MAX_BODIES];
    int q_adr[FS_MAX_BODIES];
    int v_adr[FS_MAX_BODIES];
    int body_dof[FS_MAX_BODIES];   // dof index of a 1-dof body, else -1
    int dof_body[FS_MAX_DOFS];
    int dof_mode[FS_MAX_DOFS];
    int dof_haslim[FS_MAX_DOFS];
    int geom_body[FS_MAX_GEOMS];
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

// ------------------------------------------------------------ one env

struct EnvIO {
    float* q;            // (nq, n) in/out
    float* qd;           // (nv, n) in/out
    const float* pos_target;  // (nd, n)
    const float* vel_target;  // (nd, n)
    const float* effort;      // (nd, n)
    float* slip;         // (ng*3, n) in/out
    float* dof_force;    // (nd, n) out
    float* contact_force;   // (nb*3, n) out
    float* contact_torque;  // (nb*3, n) out
};

FS_HD static void fused_env(const FusedModel& M, const EnvIO& io, int e, int n,
                            float h, float hh, int substeps) {
    const int nb = M.nb, nv = M.nv, nd = M.nd, ng = M.ng;
    float q[FS_MAX_Q], qd[FS_MAX_V], qdd[FS_MAX_V];
    for (int k = 0; k < M.nq; ++k) q[k] = io.q[(size_t)k * n + e];
    for (int k = 0; k < nv; ++k) qd[k] = io.qd[(size_t)k * n + e];

    float Rl[FS_MAX_BODIES][9], pl[FS_MAX_BODIES][3];
    float Rw[FS_MAX_BODIES][9], pw[FS_MAX_BODIES][3];
    float v[FS_MAX_BODIES][6], cb[FS_MAX_BODIES][6];
    float wang[FS_MAX_BODIES][3], wlin[FS_MAX_BODIES][3];
    float share[FS_MAX_BODIES];
    float fext[FS_MAX_BODIES][6], cf[FS_MAX_BODIES][3];
    float IA[FS_MAX_BODIES][36], pA[FS_MAX_BODIES][6];
    float U[FS_MAX_BODIES][6], dinv[FS_MAX_BODIES], uu[FS_MAX_BODIES];
    float acc[FS_MAX_BODIES][6];
    float tau[FS_MAX_DOFS], dextra[FS_MAX_DOFS];

    for (int step = 0; step < substeps; ++step) {
        // ---------------- FK ----------------
        for (int i = 0; i < nb; ++i) {
            const int jt = M.jtype[i], qa = M.q_adr[i], va = M.v_adr[i];
            const float* Rt = M.R_tree[i];
            const float* pt = M.p_tree[i];
            const float* ax = M.axis[i];
            float vj[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            if (jt == JT_FREE) {
                float Rq[9], rp[3];
                quat_to_R(q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6], Rq);
                mm3(Rt, Rq, Rl[i]);
                mv3(Rt, q + qa, rp);
                for (int k = 0; k < 3; ++k) pl[i][k] = pt[k] + rp[k];
                for (int k = 0; k < 6; ++k) vj[k] = qd[va + k];
            } else if (jt == JT_REVOLUTE) {
                float s = sinf(q[qa]), c = cosf(q[qa]), C = 1.0f - c;
                float Rj[9] = {
                    c + ax[0] * ax[0] * C, ax[0] * ax[1] * C - ax[2] * s, ax[0] * ax[2] * C + ax[1] * s,
                    ax[1] * ax[0] * C + ax[2] * s, c + ax[1] * ax[1] * C, ax[1] * ax[2] * C - ax[0] * s,
                    ax[2] * ax[0] * C - ax[1] * s, ax[2] * ax[1] * C + ax[0] * s, c + ax[2] * ax[2] * C};
                mm3(Rt, Rj, Rl[i]);
                for (int k = 0; k < 3; ++k) { pl[i][k] = pt[k]; vj[k] = ax[k] * qd[va]; }
            } else if (jt == JT_PRISMATIC) {
                float d[3] = {ax[0] * q[qa], ax[1] * q[qa], ax[2] * q[qa]}, rp[3];
                mv3(Rt, d, rp);
                for (int k = 0; k < 9; ++k) Rl[i][k] = Rt[k];
                for (int k = 0; k < 3; ++k) { pl[i][k] = pt[k] + rp[k]; vj[3 + k] = ax[k] * qd[va]; }
            } else {  // JT_FIXED
                for (int k = 0; k < 9; ++k) Rl[i][k] = Rt[k];
                for (int k = 0; k < 3; ++k) pl[i][k] = pt[k];
            }
            const int par = M.parent[i];
            if (par < 0) {
                for (int k = 0; k < 9; ++k) Rw[i][k] = Rl[i][k];
                for (int k = 0; k < 3; ++k) pw[i][k] = pl[i][k];
                for (int k = 0; k < 6; ++k) v[i][k] = vj[k];
            } else {
                float rp[3], vp[6];
                mm3(Rw[par], Rl[i], Rw[i]);
                mv3(Rw[par], pl[i], rp);
                for (int k = 0; k < 3; ++k) pw[i][k] = pw[par][k] + rp[k];
                mot_to_child(Rl[i], pl[i], v[par], vp);
                for (int k = 0; k < 6; ++k) v[i][k] = vp[k] + vj[k];
            }
            crm(v[i], vj, cb[i]);
            mv3(Rw[i], v[i], wang[i]);
            mv3(Rw[i], v[i] + 3, wlin[i]);
            for (int k = 0; k < 6; ++k) fext[i][k] = 0.0f;
            for (int k = 0; k < 3; ++k) cf[i][k] = 0.0f;
            share[i] = 0.0f;
        }

        // -------- ground contacts, pass 1: live active count per body --------
        for (int g = 0; g < ng; ++g) {
            const int b = M.geom_body[g];
            const float* o = M.geom_off[g];
            float oz = Rw[b][6] * o[0] + Rw[b][7] * o[1] + Rw[b][8] * o[2];
            if (M.geom_r[g] - (pw[b][2] + oz) > 0.0f) share[b] += 1.0f;
        }
        for (int i = 0; i < nb; ++i) share[i] = 1.0f / fmaxf(share[i], 1.0f);

        // -------- pass 2: forces with the renormalized budgets --------
        for (int g = 0; g < ng; ++g) {
            const int b = M.geom_body[g];
            const float r = M.geom_r[g];
            float off_w[3], t[3];
            mv3(Rw[b], M.geom_off[g], off_w);
            const float depth = r - (pw[b][2] + off_w[2]);
            const bool active = depth > 0.0f;
            // material velocity at the contact point (sphere bottom)
            float vel[3], bottom[3] = {0.0f, 0.0f, -r};
            cross3(wang[b], off_w, t);
            for (int k = 0; k < 3; ++k) vel[k] = wlin[b][k] + t[k];
            cross3(wang[b], bottom, t);
            for (int k = 0; k < 3; ++k) vel[k] += t[k];
            const float sh = share[b];
            const float meff = M.geom_meff[g] * sh;
            const float arrest = 0.25f * M.geom_meff[g] * sh / h;
            const float arrest_n = 1.0f * M.geom_meff[g] * sh / h;  // deadbeat normal cap
            const float kn_eff = fminf(M.kn, M.geom_meff_el[g] * sh / hh);
            const float d_pos = fminf(fmaxf(depth, 0.0f), 0.05f);
            const float v_n = vel[2];
            const float vt0 = vel[0], vt1 = vel[1];
            const float f_damp = fminf(M.kd * d_pos, arrest_n) * (-v_n);
            const float fn = active ? fmaxf(kn_eff * d_pos + f_damp, 0.0f) : 0.0f;
            const float kt_el = fminf(M.kt, meff / hh);
            const float ct = fminf(arrest, M.kt);
            // anchored-spring stiction, projected onto the Coulomb cone
            float* sp = io.slip + (size_t)(3 * g) * n + e;
            const float s0 = sp[0] + vt0 * h;
            const float s1 = sp[(size_t)n] + vt1 * h;
            const float ft0 = -kt_el * s0 - ct * vt0;
            const float ft1 = -kt_el * s1 - ct * vt1;
            const float f_mag = sqrtf(ft0 * ft0 + ft1 * ft1);
            const float f_max = M.geom_mu[g] * fn;
            const bool clamp = f_mag > f_max;
            const float scale = clamp ? f_max / fmaxf(f_mag, 1e-9f) : 1.0f;
            const float fx = ft0 * scale, fy = ft1 * scale;
            const float kdiv = fmaxf(kt_el, 1e-9f);
            sp[0] = active ? (clamp ? -fx / kdiv : s0) : 0.0f;
            sp[(size_t)n] = active ? (clamp ? -fy / kdiv : s1) : 0.0f;
            sp[(size_t)2 * n] = 0.0f;
            const float fw[3] = {active ? fx : 0.0f, active ? fy : 0.0f, fn};
            const float lever[3] = {off_w[0], off_w[1], off_w[2] - r};
            float tq[3];
            cross3(lever, fw, tq);
            for (int k = 0; k < 3; ++k) {
                fext[b][k] += tq[k];
                fext[b][3 + k] += fw[k];
                cf[b][k] += fw[k];
            }
        }

        // ---------------- joint forces + implicit diagonal ----------------
        for (int d = 0; d < nd; ++d) {
            const int b = M.dof_body[d], mode = M.dof_mode[d];
            const float dp = q[M.q_adr[b]], dv = qd[M.v_adr[b]];
            const float kp = M.dof_kp[d], kd = M.dof_kd[d];
            float ta = 0.0f;
            if (mode == DRIVE_POS) ta = kp * (io.pos_target[(size_t)d * n + e] - dp) - kd * dv;
            else if (mode == DRIVE_VEL) ta = kd * (io.vel_target[(size_t)d * n + e] - dv);
            else if (mode == DRIVE_EFFORT) ta = io.effort[(size_t)d * n + e];
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

        // ---------------- ABA: articulated inertias, inward ----------------
        for (int i = 0; i < nb; ++i) {
            float Iv[6], bias[6], nb_[3], fb_[3];
            for (int k = 0; k < 36; ++k) IA[i][k] = M.inertia[i][k];
            mv6(IA[i], v[i], Iv);
            crf(v[i], Iv, bias);
            mtv3(Rw[i], fext[i], nb_);
            mtv3(Rw[i], fext[i] + 3, fb_);
            for (int k = 0; k < 3; ++k) {
                pA[i][k] = bias[k] - nb_[k];
                pA[i][3 + k] = bias[3 + k] - fb_[k];
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
                for (int k = 0; k < 3; ++k) S[off + k] = M.axis[i][k];
                mv6(IA[i], S, U[i]);
                float di = 0.0f, sp = 0.0f;
                for (int k = 0; k < 6; ++k) { di += S[k] * U[i][k]; sp += S[k] * pA[i][k]; }
                di = di + (M.dof_armature[d] + dextra[d]);
                uu[i] = tau[d] - sp;
                dinv[i] = 1.0f / di;
                for (int r = 0; r < 6; ++r)
                    for (int c = 0; c < 6; ++c) IA[i][6 * r + c] -= U[i][r] * U[i][c] * dinv[i];
            }
            mv6(IA[i], cb[i], Ic);
            for (int k = 0; k < 6; ++k) pa[k] = pA[i][k] + Ic[k];
            if (jt != JT_FIXED)
                for (int k = 0; k < 6; ++k) pa[k] += U[i][k] * (uu[i] * dinv[i]);
            if (par >= 0) {
                float pp[6];
                add_inertia_to_parent(Rl[i], pl[i], IA[i], IA[par]);
                frc_to_parent(Rl[i], pl[i], pa, pp);
                for (int k = 0; k < 6; ++k) pA[par][k] += pp[k];
            }
        }

        // ---------------- ABA: accelerations, outward ----------------
        const float g6[6] = {0.0f, 0.0f, 0.0f, -M.gravity[0], -M.gravity[1], -M.gravity[2]};
        for (int k = 0; k < nv; ++k) qdd[k] = 0.0f;
        for (int i = 0; i < nb; ++i) {
            const int jt = M.jtype[i], par = M.parent[i], va = M.v_adr[i];
            float ap[6];
            if (par < 0) mot_to_child(Rw[i], pw[i], g6, ap);
            else mot_to_child(Rl[i], pl[i], acc[par], ap);
            for (int k = 0; k < 6; ++k) ap[k] += cb[i][k];
            if (jt == JT_FREE) {
                float Ia[6], rhs[6], sol[6];
                mv6(IA[i], ap, Ia);
                for (int k = 0; k < 6; ++k) rhs[k] = -(pA[i][k] + Ia[k]);
                chol_solve6(IA[i], rhs, sol);
                for (int k = 0; k < 6; ++k) { qdd[va + k] = sol[k]; acc[i][k] = ap[k] + sol[k]; }
            } else if (jt == JT_FIXED) {
                for (int k = 0; k < 6; ++k) acc[i][k] = ap[k];
            } else {
                float Ua = 0.0f;
                for (int k = 0; k < 6; ++k) Ua += U[i][k] * ap[k];
                const float qi = (uu[i] - Ua) * dinv[i];
                qdd[va] = qi;
                const int off = (jt == JT_REVOLUTE) ? 0 : 3;
                for (int k = 0; k < 6; ++k) acc[i][k] = ap[k];
                for (int k = 0; k < 3; ++k) acc[i][off + k] += M.axis[i][k] * qi;
            }
        }

        // ---------------- integrate (semi-implicit Euler) ----------------
        for (int k = 0; k < nv; ++k) qd[k] = qd[k] + qdd[k] * h;
        for (int d = 0; d < nd; ++d) {
            const int va = M.v_adr[M.dof_body[d]];
            qd[va] = fminf(fmaxf(qd[va], -M.dof_maxvel[d]), M.dof_maxvel[d]);
        }
        for (int b = 0; b < nb; ++b) {
            if (M.jtype[b] != JT_FREE) continue;
            const int qa = M.q_adr[b], va = M.v_adr[b];
            for (int k = 0; k < 3; ++k) {
                qd[va + k] = fminf(fmaxf(qd[va + k], -M.max_angvel), M.max_angvel);
                qd[va + 3 + k] = fminf(fmaxf(qd[va + 3 + k], -M.max_linvel), M.max_linvel);
            }
            const float quat[4] = {q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6]};
            float om[3], vw[3];
            quat_apply(quat, qd + va, om);
            quat_apply(quat, qd + va + 3, vw);
            for (int k = 0; k < 3; ++k) q[qa + k] = q[qa + k] + vw[k] * h;
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
        for (int d = 0; d < nd; ++d) {
            const int b = M.dof_body[d];
            q[M.q_adr[b]] = q[M.q_adr[b]] + qd[M.v_adr[b]] * h;
        }
    }

    for (int k = 0; k < M.nq; ++k) io.q[(size_t)k * n + e] = q[k];
    for (int k = 0; k < nv; ++k) io.qd[(size_t)k * n + e] = qd[k];
    for (int d = 0; d < nd; ++d) io.dof_force[(size_t)d * n + e] = tau[d];
    for (int b = 0; b < nb; ++b)
        for (int k = 0; k < 3; ++k) {
            io.contact_force[(size_t)(3 * b + k) * n + e] = cf[b][k];
            io.contact_torque[(size_t)(3 * b + k) * n + e] = fext[b][k];
        }
}

#ifdef __CUDACC__
__global__ void fused_substep_kernel(const FusedModel* __restrict__ model, EnvIO io, int n,
                                     float h, float hh, int substeps) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e < n) fused_env(*model, io, e, n, h, hh, substeps);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fused_substep_launch(const void* model, float* q, float* qd,
                                    const float* pos_target, const float* vel_target,
                                    const float* effort, float* slip, float* dof_force,
                                    float* contact_force, float* contact_torque,
                                    int n, float h, float hh, int substeps, void* stream) {
    EnvIO io{q, qd, pos_target, vel_target, effort, slip, dof_force, contact_force, contact_torque};
    const int threads = 32;  // one warp per block: spreads 4096 envs over 128 SMs
    const int blocks = (n + threads - 1) / threads;
    fused_substep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const FusedModel*)model, io, n, h, hh, substeps);
    return (int)cudaGetLastError();
}
#endif
