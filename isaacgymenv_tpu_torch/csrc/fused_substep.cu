// Fused physics substep loop for Hopper (sm_90a): one thread per env.
//
// Replaces the TPU kernel isaacgymenv_tpu/physics/fused.py:build_fused_substep
// for the scenes that isaacgymenv_tpu_torch/physics/fused.py:fused_structural_ok
// accepts: free roots + revolute/prismatic/fixed joints, DRIVE_* dof drives
// with limits/friction/armature, sphere contacts against the ground with the
// stiction slip carry (none when the scene has no geoms), force sensors and
// per-body external wrenches, no pairs/anchors/tendons.  The ground is the
// plane z = 0, or a heightfield sampled by the caller once per control step
// (terrain_mode: per-geom height and normal, held across the substeps as the
// TPU kernel holds them); friction is the table's or per env (fric_mode); the
// body wrenches (wrench_mode: world [moment, force] per body, held for all
// substeps of the launch) are added to f_ext after the contact torque is
// taken, so that it stays the contacts' moment (fused.py:993-1001).
// Each thread runs all `substeps` iterations of one control step for its env:
// FK -> ground contacts (two passes: live per-body counts, then forces) ->
// drive/passive forces + implicit diagonal -> ABA -> velocity clamps and
// semi-implicit integration.  The last substep's dof force, contact
// force/torque and, when the scene has force sensors, each sensor body's
// inbound joint wrench (the ABA's joint force, as the TPU kernel's
// sensor output) are written out; the caller refreshes the body caches.
//
// Unlike the Pallas kernel, which unrolls the model into code at trace time,
// this is one fixed source: the model arrives as data (struct FusedModel,
// filled by the Python wrapper) and the caps of substep_common.cuh bound the per-thread
// arrays.  One build serves every model under the caps.  The optional inputs
// of the TPU kernel's modes are pointers, null when the mode is off, so the
// branches on them are uniform across the grid.
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
// broadcast from cache), and the slip state, the held ground and the per-env
// friction are streamed from device memory per geom.  Occupancy, shared
// memory and warp-per-env are later work.
//
// The per-env body is __host__ __device__ plain C++ so it also compiles as
// host code; only the __global__ kernel and the launch function need nvcc.
// FK, ground contacts, joint forces, ABA and integration live in
// substep_common.cuh, shared with the split kernels (split_substep.cu).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: it changes sqrt/division
//        rounding against the plain version).

#include "substep_common.cuh"

// ------------------------------------------------------------ one env

struct EnvIO {
    float* q;            // (nq, n) in/out
    float* qd;           // (nv, n) in/out
    const float* pos_target;  // (nd, n)
    const float* vel_target;  // (nd, n)
    const float* effort;      // (nd, n)
    float* slip;         // (ng*3, n) in/out
    Ground ground;       // held height (ng, n) + normal (ng*3, n), friction (ng, n); null = off
    const float* bw;     // (nb*6, n) or null: body wrenches, world [moment, force] about each body origin
    float* dof_force;    // (nd, n) out
    float* contact_force;   // (nb*3, n) out
    float* contact_torque;  // (nb*3, n) out
    float* joint_wrench; // (ns*6, n) out or null: sensor wrenches [force, torque], body frame
    float* probe;        // (substeps*2*ng, n) out or null: per substep, each geom's depth and clamp margin
};

FS_HD static void fused_env(const FusedModel& M, const EnvIO& io, int e, int n,
                            float h, float hh, int substeps) {
    const int nb = M.nb, nv = M.nv, nd = M.nd;
    float q[FS_MAX_Q], qd[FS_MAX_V], qdd[FS_MAX_V];
    for (int k = 0; k < M.nq; ++k) q[k] = io.q[(size_t)k * n + e];
    for (int k = 0; k < nv; ++k) qd[k] = io.qd[(size_t)k * n + e];

    Kin kin;
    float share[FS_MAX_BODIES];
    float fext[FS_MAX_BODIES][6], cf[FS_MAX_BODIES][3];
    float tau[FS_MAX_DOFS], dextra[FS_MAX_DOFS];
    float jw[FS_MAX_SENSORS * 6];

    for (int step = 0; step < substeps; ++step) {
        fk(M, q, qd, kin);
        for (int i = 0; i < nb; ++i) {
            for (int k = 0; k < 6; ++k) fext[i][k] = 0.0f;
            for (int k = 0; k < 3; ++k) cf[i][k] = 0.0f;
            share[i] = 0.0f;
        }
        // ground contacts, pass 1: live active count per body; pass 2:
        // forces with the renormalized budgets
        ground_count(M, kin, io.ground, e, n, share);
        for (int i = 0; i < nb; ++i) share[i] = 1.0f / fmaxf(share[i], 1.0f);
        float* probe = io.probe ? io.probe + (size_t)step * 2 * M.ng * n : nullptr;
        ground_forces(M, kin, io.ground, share, io.slip, e, n, h, hh, fext, cf, probe);
        if (step == substeps - 1)  // the last substep's contacts, before any body wrench
            for (int b = 0; b < nb; ++b)
                for (int k = 0; k < 3; ++k) {
                    io.contact_force[(size_t)(3 * b + k) * n + e] = cf[b][k];
                    io.contact_torque[(size_t)(3 * b + k) * n + e] = fext[b][k];
                }
        if (io.bw)
            for (int b = 0; b < nb; ++b)
                for (int k = 0; k < 6; ++k) fext[b][k] += io.bw[(size_t)(6 * b + k) * n + e];
        joint_forces(M, q, qd, io.pos_target, io.vel_target, io.effort, e, n, h, hh, tau, dextra);
        aba(M, kin, tau, dextra, fext, qdd, io.joint_wrench && step == substeps - 1 ? jw : nullptr);
        integrate(M, q, qd, qdd, h);
    }

    for (int k = 0; k < M.nq; ++k) io.q[(size_t)k * n + e] = q[k];
    for (int k = 0; k < nv; ++k) io.qd[(size_t)k * n + e] = qd[k];
    for (int d = 0; d < nd; ++d) io.dof_force[(size_t)d * n + e] = tau[d];
    if (io.joint_wrench)
        for (int k = 0; k < 6 * M.ns; ++k) io.joint_wrench[(size_t)k * n + e] = jw[k];
}

#ifdef __CUDACC__
__global__ void fused_substep_kernel(const FusedModel* __restrict__ model, EnvIO io, int n,
                                     float h, float hh, int substeps) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e < n) fused_env(*model, io, e, n, h, hh, substeps);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// ground_h, ground_n, geom_fric, bw, joint_wrench and probe may be null (mode
// off / not wanted); joint_wrench must be given when the model has sensors;
// slip may be null when the model has no geoms.
extern "C" int fused_substep_launch(const void* model, float* q, float* qd,
                                    const float* pos_target, const float* vel_target,
                                    const float* effort, float* slip, const float* ground_h,
                                    const float* ground_n, const float* geom_fric, const float* bw,
                                    float* dof_force,
                                    float* contact_force, float* contact_torque, float* joint_wrench,
                                    float* probe,
                                    int n, float h, float hh, int substeps, void* stream) {
    EnvIO io{q, qd, pos_target, vel_target, effort, slip, Ground{ground_h, ground_n, geom_fric}, bw,
             dof_force, contact_force, contact_torque, joint_wrench, probe};
    const int threads = 32;  // one warp per block: spreads 4096 envs over 128 SMs
    const int blocks = (n + threads - 1) / threads;
    fused_substep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const FusedModel*)model, io, n, h, hh, substeps);
    return (int)cudaGetLastError();
}
#endif
