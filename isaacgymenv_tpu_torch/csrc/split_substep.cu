// Split physics substep for Hopper (sm_90a): a contacts kernel (B2) and a
// dynamics kernel (B3), one thread per env, launched once each per substep.
//
// Replaces the TPU kernels of isaacgymenv_tpu/physics/fused_split.py:
// `contacts_kernel` (:350) and `dynamics_kernel` (:755), for the scenes that
// isaacgymenv_tpu_torch/physics/fused_split.py:split_structural_ok accepts:
// B1's joints and drives (substep_common.cuh), flat-ground or `no_ground`
// scenes, body-vs-body pair contacts of spheres against sphere, box, capsule
// and capped-cylinder surfaces, world anchors, fixed tendons, B2's wrench
// mode (an optional external wrench per body, `bw`) and B3's sensor output
// (an optional `joint_wrench`).  No gravity compensation, terrain or
// per-env model leaves.
//
// B2: FK -> pass 1 counts the live contacts per body (ground geoms, then a
// rolled loop over the pair table) -> pass 2 divides each contact's
// effective-mass budget by its bodies' counts and accumulates the forces
// per body (ground, then pairs) -> the world anchors' spring-dampers
// (fused_split.py:705-723) -> writes the contact force and torque (the
// torque is the moment of the contacts and anchors), then adds the body
// wrench when `bw` is given (wrench mode, the order of
// fused_split.py:742-749: the contact torque holds no wrench) and writes the
// world external wrench f_ext per body; the slip states are updated in
// place.  B3: FK again (as the TPU kernel does, rather than moving 36 floats
// per body through memory) -> drive, passive and tendon forces -> ABA with
// f_ext -> semi-implicit integration; q and qd are updated in place; when
// `joint_wrench` is given, each sensor body's inbound joint wrench from
// that launch's ABA (fused_split.py:955-960; the caller passes it to the
// last substep's launch only).  The contact force/torque of the last
// substep's B2 and the dof force and sensor wrenches of its B3 are the
// step's (PhysX CC_LAST_SUBSTEP).
//
// The model is data: struct SplitModel (the FusedModel table plus the
// tendons) and the pair table, `pint` (n_pairs x 4, int32) and `pflt`
// (n_pairs x 25, fp32) in the slots of the TPU kernel (fused_split.py:83-101),
// filled by physics/fused_split.py.  One build serves every model under the
// caps.  The pair loop reads its parameters from the table (uniform across a
// warp, served by broadcast from cache) and the body state from the FK
// result, the per-thread staging array of R_w, p_w, angular and linear
// velocity per body (18 floats, the TPU kernel's _BS_W).  Every input and
// output is env-minor, element (k, env) at k * n + env.
//
// What bounds it: B2 streams the pair slip state (3 floats per pair, read
// and written) and loops twice over the pairs per env (in wrench mode it
// also reads 6 floats per body, one add each); B3 is B1's serial
// FK + ABA chain.  Per-body state lives in per-thread local arrays, as in
// B1.  This is the simple design; the layout is later work.
//
// The per-env bodies are __host__ __device__ plain C++, like B1's.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).

#include "substep_common.cuh"

#define SP_MAX_TENDONS 8
#define SP_MAX_TENDON_DOFS 4
#define SP_MAX_PAIRS 1024
#define SP_MAX_ANCHORS 8

// pair table slots (fused_split.py:83-101)
enum { PI_G = 0, PI_GB = 1, PI_SB = 2, PI_KIND = 3, PI_N = 4 };
enum {
    PF_RG = 0, PF_MG = 1, PF_MGEL = 2, PF_MS = 3, PF_MSEL = 4, PF_MU_S = 5, PF_MU = 6,
    PF_OFF = 7, PF_SIZE = 10, PF_ROTM = 13, PF_GOFF = 22, PF_N = 25
};
enum { SURF_SPHERE = 0, SURF_BOX = 1, SURF_CAPSULE = 2, SURF_CYLINDER = 3 };

// Mirrored field for field by the ctypes.Structure in physics/fused_split.py.
// Every member is 4 bytes wide, so the layout has no padding.
struct SplitModel {
    FusedModel base;
    int no_ground, n_pairs, nt;
    int tendon_n[SP_MAX_TENDONS];                     // dofs per tendon
    int tendon_dof[SP_MAX_TENDONS][SP_MAX_TENDON_DOFS];
    float tendon_coef[SP_MAX_TENDONS][SP_MAX_TENDON_DOFS];
    float tendon_lo[SP_MAX_TENDONS], tendon_hi[SP_MAX_TENDONS];
    float tendon_k[SP_MAX_TENDONS], tendon_d[SP_MAX_TENDONS];
    int na;                                           // world anchors
    int anchor_body[SP_MAX_ANCHORS];
    float anchor_off[SP_MAX_ANCHORS][3];              // body frame
    float anchor_target[SP_MAX_ANCHORS][3];           // world
    float anchor_meff[SP_MAX_ANCHORS];
};

FS_HD static inline float sgn(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }

// Closest feature of a surface to the point `local` (surface frame): the
// normal nl pointing away from the surface and the signed distance (negative
// inside), as contact._surface_closest selects them by kind.
FS_HD static float surface_closest(int kind, const float* l, const float* sz, float* nl) {
    const float eps = 1e-9f;
    if (kind == SURF_SPHERE) {
        const float dist = sqrtf(l[0] * l[0] + l[1] * l[1] + l[2] * l[2]);
        const float inv = 1.0f / fmaxf(dist, eps);
        for (int c = 0; c < 3; ++c) nl[c] = l[c] * inv;
        return dist - sz[0];
    }
    if (kind == SURF_BOX) {
        float delta[3], face[3];
        for (int c = 0; c < 3; ++c) {
            delta[c] = l[c] - fminf(fmaxf(l[c], -sz[c]), sz[c]);
            face[c] = sz[c] - fabsf(l[c]);
        }
        const float dist_out = sqrtf(delta[0] * delta[0] + delta[1] * delta[1] + delta[2] * delta[2]);
        if (dist_out > eps) {
            const float inv = 1.0f / fmaxf(dist_out, eps);
            for (int c = 0; c < 3; ++c) nl[c] = delta[c] * inv;
            return dist_out;
        }
        // inside: the nearest face (first of equal ones)
        const int k = (face[0] <= face[1] && face[0] <= face[2]) ? 0 : (face[1] <= face[2] ? 1 : 2);
        for (int c = 0; c < 3; ++c) nl[c] = c == k ? sgn(l[k]) : 0.0f;
        return -face[k];
    }
    if (kind == SURF_CAPSULE) {  // [R, half length] along local z
        const float seg_z = fminf(fmaxf(l[2], -sz[1]), sz[1]);
        const float d[3] = {l[0], l[1], l[2] - seg_z};
        const float dist = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
        const float inv = 1.0f / fmaxf(dist, eps);
        for (int c = 0; c < 3; ++c) nl[c] = d[c] * inv;
        return dist - sz[0];
    }
    // capped cylinder [R, half length] along local z, flat caps
    const float rho = sqrtf(l[0] * l[0] + l[1] * l[1]);
    const float inv_rho = 1.0f / fmaxf(rho, eps);
    const float rd0 = l[0] * inv_rho, rd1 = l[1] * inv_rho;
    const float dr = rho - sz[0];
    const float dz = fabsf(l[2]) - sz[1];
    const float sz_ = sgn(l[2]);
    const float d_in = fmaxf(dr, dz);
    if (d_in < 0.0f) {
        const bool cap = dz > dr;
        nl[0] = cap ? 0.0f : rd0;
        nl[1] = cap ? 0.0f : rd1;
        nl[2] = cap ? sz_ : 0.0f;
        return d_in;
    }
    const float out_r = fmaxf(dr, 0.0f), out_z = fmaxf(dz, 0.0f);
    const float d_out = sqrtf(out_r * out_r + out_z * out_z);
    const float inv = 1.0f / fmaxf(d_out, eps);
    nl[0] = out_r * rd0 * inv;
    nl[1] = out_r * rd1 * inv;
    nl[2] = out_z * sz_ * inv;
    return d_out;
}

// Surface query of pair p: the sphere center c and the world normal n (away
// from the surface); returns the penetration depth (> 0: in contact).
FS_HD static float pair_query(const int* pi, const float* pf, const Kin& k, float* c, float* n) {
    const int gb = pi[PI_GB], sb = pi[PI_SB];
    float t[3], Rs[9], ps[3], d[3], local[3], nl[3];
    mv3(k.Rw[gb], pf + PF_GOFF, t);
    for (int i = 0; i < 3; ++i) c[i] = k.pw[gb][i] + t[i];
    mm3(k.Rw[sb], pf + PF_ROTM, Rs);
    mv3(k.Rw[sb], pf + PF_OFF, t);
    for (int i = 0; i < 3; ++i) { ps[i] = k.pw[sb][i] + t[i]; d[i] = c[i] - ps[i]; }
    mtv3(Rs, d, local);
    const float d_surf = surface_closest(pi[PI_KIND], local, pf + PF_SIZE, nl);
    mv3(Rs, nl, n);
    return pf[PF_RG] - d_surf;
}

// ------------------------------------------------------------ B2: contacts

struct ContactsIO {
    const float* q;     // (nq, n)
    const float* qd;    // (nv, n)
    float* slip_g;      // (ng*3, n) in/out; unused by no_ground scenes
    float* slip_p;      // (n_pairs*3, n) in/out
    float* fext;        // (nb*6, n) out: world [moment, force] about each body origin
    float* cf;          // (nb*3, n) out: contact force
    float* ct;          // (nb*3, n) out: contact torque (the moment of fext)
    float* counts;      // (nb, n) out, or null: live contacts per body (pass 1)
    const float* bw;    // (nb*6, n) or null: the body wrenches of wrench mode, world [moment, force]
};

FS_HD static void contacts_env(const SplitModel& S, const int* pint, const float* pflt,
                               const ContactsIO& io, int e, int n, float h, float hh) {
    const FusedModel& M = S.base;
    const int nb = M.nb;
    float q[FS_MAX_Q], qd[FS_MAX_V];
    for (int i = 0; i < M.nq; ++i) q[i] = io.q[(size_t)i * n + e];
    for (int i = 0; i < M.nv; ++i) qd[i] = io.qd[(size_t)i * n + e];
    Kin kin;
    fk(M, q, qd, kin);

    float share[FS_MAX_BODIES], fext[FS_MAX_BODIES][6], cf[FS_MAX_BODIES][3];
    for (int b = 0; b < nb; ++b) {
        share[b] = 0.0f;
        for (int c = 0; c < 6; ++c) fext[b][c] = 0.0f;
        for (int c = 0; c < 3; ++c) cf[b][c] = 0.0f;
    }

    // pass 1: live contact counts per body (a pair loads both of its bodies)
    const Ground plane{nullptr, nullptr, nullptr};  // B2 has no terrain_mode or fric_mode yet
    if (!S.no_ground) ground_count(M, kin, plane, e, n, share);
    for (int p = 0; p < S.n_pairs; ++p) {
        const int* pi = pint + PI_N * p;
        float c[3], nw[3];
        if (pair_query(pi, pflt + PF_N * p, kin, c, nw) > 0.0f) {
            share[pi[PI_GB]] += 1.0f;
            share[pi[PI_SB]] += 1.0f;
        }
    }
    if (io.counts)
        for (int b = 0; b < nb; ++b) io.counts[(size_t)b * n + e] = share[b];
    for (int b = 0; b < nb; ++b) share[b] = 1.0f / fmaxf(share[b], 1.0f);

    // pass 2: forces with the renormalized budgets
    if (!S.no_ground) ground_forces(M, kin, plane, share, io.slip_g, e, n, h, hh, fext, cf, nullptr);
    for (int p = 0; p < S.n_pairs; ++p) {
        const int* pi = pint + PI_N * p;
        const float* pf = pflt + PF_N * p;
        const int gb = pi[PI_GB], sb = pi[PI_SB];
        float c[3], nw[3];
        const float depth = pair_query(pi, pf, kin, c, nw);
        const bool active = depth > 0.0f;
        const float r = pf[PF_RG];
        // contact point on the sphere, toward the surface
        float lever_g[3], lever_s[3], vg[3], vs[3], v_rel[3], v_t[3];
        for (int i = 0; i < 3; ++i) {
            const float xc = c[i] - nw[i] * r;
            lever_g[i] = xc - kin.pw[gb][i];
            lever_s[i] = xc - kin.pw[sb][i];
        }
        cross3(kin.wang[gb], lever_g, vg);
        cross3(kin.wang[sb], lever_s, vs);
        for (int i = 0; i < 3; ++i) v_rel[i] = (kin.wlin[gb][i] + vg[i]) - (kin.wlin[sb][i] + vs[i]);
        const float v_n = v_rel[0] * nw[0] + v_rel[1] * nw[1] + v_rel[2] * nw[2];
        for (int i = 0; i < 3; ++i) v_t[i] = v_rel[i] - v_n * nw[i];

        // reduced effective masses of the pair, each side's budget shared
        const float m_g = pf[PF_MG] * share[gb], m_s = pf[PF_MS] * share[sb];
        const float m_pair = m_g * m_s / (m_g + m_s);
        const float arrest = 0.25f * m_pair / h;
        const float arrest_n = 1.0f * m_pair / h;  // deadbeat normal cap
        const float mg_el = pf[PF_MGEL] * share[gb], ms_el = pf[PF_MSEL] * share[sb];
        const float kn_eff = fminf(M.kn, mg_el * ms_el / (mg_el + ms_el) / hh);
        const float d_pos = fminf(fmaxf(depth, 0.0f), 0.05f);
        const float f_damp = fminf(M.kd * d_pos, arrest_n) * (-v_n);
        const float fn = active ? fmaxf(kn_eff * d_pos + f_damp, 0.0f) : 0.0f;
        const float kt_el = fminf(M.kt, m_pair / hh);
        const float ct = fminf(arrest, M.kt);

        // anchored-spring stiction, projected onto the Coulomb cone
        float* sp = io.slip_p + (size_t)(3 * p) * n + e;
        float s[3], ft[3];
        for (int i = 0; i < 3; ++i) s[i] = sp[(size_t)i * n] + v_t[i] * h;
        const float s_n = s[0] * nw[0] + s[1] * nw[1] + s[2] * nw[2];
        for (int i = 0; i < 3; ++i) {
            s[i] = s[i] - s_n * nw[i];
            ft[i] = -kt_el * s[i] - ct * v_t[i];
        }
        const float f_mag = sqrtf(ft[0] * ft[0] + ft[1] * ft[1] + ft[2] * ft[2]);
        const float f_max = pf[PF_MU] * fn;
        const bool clamp = f_mag > f_max;
        const float scale = clamp ? f_max / fmaxf(f_mag, 1e-9f) : 1.0f;
        const float kdiv = fmaxf(kt_el, 1e-9f);
        float f[3], f_neg[3], tq_g[3], tq_s[3];
        for (int i = 0; i < 3; ++i) {
            ft[i] = ft[i] * scale;
            sp[(size_t)i * n] = active ? (clamp ? -ft[i] / kdiv : s[i]) : 0.0f;
            f[i] = fn * nw[i] + (active ? ft[i] : 0.0f);  // on the sphere's body
            f_neg[i] = -f[i];
        }
        cross3(lever_g, f, tq_g);
        cross3(lever_s, f_neg, tq_s);
        for (int i = 0; i < 3; ++i) {
            fext[gb][i] += tq_g[i];
            fext[gb][3 + i] += f[i];
            cf[gb][i] += f[i];
            fext[sb][i] += tq_s[i];
            fext[sb][3 + i] += f_neg[i];
            cf[sb][i] += f_neg[i];
        }
    }

    // world anchors, after the pairs (fused_split.py:705-723)
    for (int a = 0; a < S.na; ++a) {
        const int b = S.anchor_body[a];
        anchor_force(kin.Rw[b], kin.pw[b], kin.wang[b], kin.wlin[b], S.anchor_off[a], S.anchor_target[a],
                     S.anchor_meff[a], h, hh, fext[b]);
    }

    for (int b = 0; b < nb; ++b) {
        for (int c = 0; c < 3; ++c) {
            io.cf[(size_t)(3 * b + c) * n + e] = cf[b][c];
            io.ct[(size_t)(3 * b + c) * n + e] = fext[b][c];  // contacts and anchors, before the wrench
        }
        for (int c = 0; c < 6; ++c) {
            float v = fext[b][c];
            if (io.bw) v += io.bw[(size_t)(6 * b + c) * n + e];
            io.fext[(size_t)(6 * b + c) * n + e] = v;
        }
    }
}

// ------------------------------------------------------------ B3: dynamics

struct DynamicsIO {
    float* q;                 // (nq, n) in/out
    float* qd;                // (nv, n) in/out
    const float* pos_target;  // (nd, n)
    const float* vel_target;  // (nd, n)
    const float* effort;      // (nd, n)
    const float* fext;        // (nb*6, n) from B2
    float* dof_force;         // (nd, n) out
    float* joint_wrench;      // (ns*6, n) out or null: sensor wrenches [force, torque], body frame
};

FS_HD static void dynamics_env(const SplitModel& S, const DynamicsIO& io, int e, int n, float h, float hh) {
    const FusedModel& M = S.base;
    float q[FS_MAX_Q], qd[FS_MAX_V], qdd[FS_MAX_V];
    for (int i = 0; i < M.nq; ++i) q[i] = io.q[(size_t)i * n + e];
    for (int i = 0; i < M.nv; ++i) qd[i] = io.qd[(size_t)i * n + e];
    Kin kin;
    fk(M, q, qd, kin);
    float fext[FS_MAX_BODIES][6];
    for (int b = 0; b < M.nb; ++b)
        for (int c = 0; c < 6; ++c) fext[b][c] = io.fext[(size_t)(6 * b + c) * n + e];

    float tau[FS_MAX_DOFS], dextra[FS_MAX_DOFS];
    joint_forces(M, q, qd, io.pos_target, io.vel_target, io.effort, e, n, h, hh, tau, dextra);
    // fixed tendons: L = sum(coef q) held in [lo, hi] by a spring-damper,
    // its force f * coef on each coupled dof
    for (int t = 0; t < S.nt; ++t) {
        float L = 0.0f, Ld = 0.0f;
        for (int j = 0; j < S.tendon_n[t]; ++j) {
            const int b = M.dof_body[S.tendon_dof[t][j]];
            L += S.tendon_coef[t][j] * q[M.q_adr[b]];
            Ld += S.tendon_coef[t][j] * qd[M.v_adr[b]];
        }
        const float viol = fmaxf(L - S.tendon_hi[t], 0.0f) + fminf(L - S.tendon_lo[t], 0.0f);
        const float f = -S.tendon_k[t] * viol - S.tendon_d[t] * Ld * (fabsf(viol) > 0.0f ? 1.0f : 0.0f);
        for (int j = 0; j < S.tendon_n[t]; ++j) tau[S.tendon_dof[t][j]] += f * S.tendon_coef[t][j];
    }
    float jw[FS_MAX_SENSORS * 6];
    aba(M, kin, tau, dextra, fext, qdd, io.joint_wrench ? jw : nullptr);
    integrate(M, q, qd, qdd, h);

    for (int i = 0; i < M.nq; ++i) io.q[(size_t)i * n + e] = q[i];
    for (int i = 0; i < M.nv; ++i) io.qd[(size_t)i * n + e] = qd[i];
    for (int d = 0; d < M.nd; ++d) io.dof_force[(size_t)d * n + e] = tau[d];
    if (io.joint_wrench)
        for (int k = 0; k < 6 * M.ns; ++k) io.joint_wrench[(size_t)k * n + e] = jw[k];
}

#ifdef __CUDACC__
__global__ void split_contacts_kernel(const SplitModel* __restrict__ model, const int* __restrict__ pint,
                                      const float* __restrict__ pflt, ContactsIO io, int n, float h, float hh) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e < n) contacts_env(*model, pint, pflt, io, e, n, h, hh);
}

__global__ void split_dynamics_kernel(const SplitModel* __restrict__ model, DynamicsIO io, int n,
                                      float h, float hh) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e < n) dynamics_env(*model, io, e, n, h, hh);
}

static const int kThreads = 64;  // two warps per block

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int split_contacts_launch(const void* model, const int* pint, const float* pflt,
                                     const float* q, const float* qd, float* slip_g, float* slip_p,
                                     float* fext, float* cf, float* ct, float* counts, const float* bw,
                                     int n, float h, float hh, void* stream) {
    ContactsIO io{q, qd, slip_g, slip_p, fext, cf, ct, counts, bw};
    split_contacts_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const SplitModel*)model, pint, pflt, io, n, h, hh);
    return (int)cudaGetLastError();
}

// joint_wrench may be null (no sensor output wanted from this launch).
extern "C" int split_dynamics_launch(const void* model, float* q, float* qd, const float* pos_target,
                                     const float* vel_target, const float* effort, const float* fext,
                                     float* dof_force, float* joint_wrench, int n, float h, float hh,
                                     void* stream) {
    DynamicsIO io{q, qd, pos_target, vel_target, effort, fext, dof_force, joint_wrench};
    split_dynamics_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const SplitModel*)model, io, n, h, hh);
    return (int)cudaGetLastError();
}
#endif
