// Blocked-ELL SpMM (SUM) for Hopper (sm_90a): the hybrid plan's middle
// tier.
//
// Replaces the TPU kernel `dgsparse_tpu/kernels/pallas_spmm.py::spmm_bell`
// (body `_bell_kernel`). There each tile of `edge_tile` edge slots, all in
// one (128-row block x 128-column window) cell, gathers its rows of B by a
// one-hot [E, C] matmul against the window and scatters the scaled rows
// into the row block by a one-hot [R, E] matmul, so no random memory
// access reaches HBM; the row block's sum rides in VMEM across the
// sequential grid. On the H100 a dense product over such a cell (1 % or
// less of it filled) does ~80x the work, and a gather costs no more than
// the load it is.
//
// What bounds it: bytes, and the latency of its gathers. On a
// Reddit-scale hybrid plan the BELL tier is small and scattered (147,206
// edges on 13,139 of 232,965 rows; a tile reads a median of 10 of its
// window's 128 rows), so the compulsory traffic is the distinct B rows its
// edges reference, its real slots (column and value, 8 bytes each) and the
// BELL rows of `out`, read and written once. The rows are skewed, though:
// the median row has 5 slots, 421 rows have 64 or more (up to 441) and
// hold half of them, and a row's sum is a chain in slot order, so a long
// row's gathers must be many in flight at once. The row-run kernels move
// only the compulsory bytes:
//   - the plan lists the rows that have BELL edges, short rows then long
//     ones, and per row its runs: within a tile a row's slots are
//     consecutive (the planner keeps CSR order inside a cell), so a run
//     is a first slot and a length. Padding slots and the all-padding
//     tiles of empty row blocks are in no run;
//   - short rows (`bell_rows_kernel`): a group of G lanes a row, in
//     `csr_spmm`'s group mapping (`kernels/spmm_csr.py::spmm_path`: VEC
//     elements a load, G lanes a row, NV vectors a lane, feature slices
//     on gridDim.y); a round of G slots' columns and values is loaded a
//     round ahead, coalesced, broadcast by __shfl_sync(width G), and
//     B[window * 128 + column] is gathered straight from global memory
//     and L2 with the widest loads, 4 slots' gathers before their FMAs;
//   - long rows (`bell_long_kernel`): a warp a row and 32 features (4
//     bytes a lane), rounds of 32 slots pipelined so that the next
//     round's 32 gathers are in flight during this round's FMAs, the
//     columns read from shared memory (a shuffle a slot serialised the
//     gathers). Its grid runs first and lets the short rows' grid start
//     beside it (programmatic dependent launch); that grid finishes only
//     after it, so the stream sees one operation;
//   - both add into `out` in place: out[row] += the row's sum, for the
//     BELL rows only; the hybrid SpMM passes its tier sum, so no [M, F]
//     BELL output is written and read back. Rows without BELL edges are
//     not touched, and out's rows are read before the gathers so that
//     their latency hides behind them.
// Order of the sum: each run sums from 0 by fmaf in slot order, and the
// runs' sums are added in tile order into a row sum that starts at 0,
// which is then added to out[row] once (`tests/test_torch_bell.py::
// _emulate` replays it); no atomics, so results are repeatable.

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kAhead = 4;  // short rows: slots whose gathers are issued
                           // before their FMAs
constexpr int kLongWarps = 4;  // long rows: warps (rows) a block

// Most vectors a lane carries: two of 16 bytes, else four
// (`kernels/spmm_csr.py::max_vectors`).
template <typename T, int VEC>
__host__ __device__ constexpr int max_vectors() {
  return VEC * static_cast<int>(sizeof(T)) == 16 ? 2 : 4;
}

// Floats of out a load or store moves beside a vector of VEC elements of
// B: as many bytes as the B load (at least one float), so out needs no
// more alignment than B.
template <typename T, int VEC>
__host__ __device__ constexpr int out_width() {
  return VEC * static_cast<int>(sizeof(T)) >= 4
             ? VEC * static_cast<int>(sizeof(T)) / 4
             : 1;
}

// One BELL row's runs, walked round by round by a group of `group` lanes
// (all of them calling every member, so that the full-mask shuffles meet):
// a round is `group` consecutive slots of one run, a slot a lane; lane l
// holds the header of run kb + l (first slot, length, window base) and
// loads its slot's column and value of the next round a round ahead.
struct RunCursor {
  const int *run_slot, *run_len, *tile_cw, *lcol;
  const float* vals;
  int edge_tile, col_window, group, li, k1;
  int kb = 0, kk = 0, base = 0;  // the next round: run kb + kk, from base
  int s0 = 0, len = 0, win = 0;  // ... that run's header
  int h_slot = 0, h_len = 0, h_win = 0;
  bool active = false;           // the next round exists
  int c = 0, c_next = 0;         // the current and next rounds' columns
  float w = 0.f, w_next = 0.f;   // ... and values

  __device__ void load_headers() {
    if (kb + li < k1) {
      h_slot = run_slot[kb + li];
      h_len = run_len[kb + li];
      h_win = tile_cw[h_slot / edge_tile] * col_window;
    }
  }

  __device__ void load_round() {
    const int e = base + li;
    const bool ok = active && e < len;
    c_next = ok ? lcol[s0 + e] : 0;
    w_next = ok ? vals[s0 + e] : 0.f;
  }

  __device__ void shuffle_header() {
    s0 = __shfl_sync(kFullMask, h_slot, kk, group);
    len = __shfl_sync(kFullMask, h_len, kk, group);
  }

  // The row's runs [k0, k1); the first round's columns and values on
  // their way.
  __device__ void start(int k0) {
    kb = k0;
    active = k0 < k1;
    load_headers();
    shuffle_header();
    load_round();
    win = __shfl_sync(kFullMask, h_win, kk, group);
  }

  // Makes the next round current (c, w: its n slots, in the window at
  // `round_win`; `run_done` where it ends its run) and starts loading the
  // one after.
  __device__ void advance(int& n, int& round_win, bool& run_done) {
    c = c_next;
    w = w_next;
    n = active ? min(group, len - base) : 0;
    round_win = win;
    run_done = false;
    if (active) {
      base += group;
      if (base >= len) {
        run_done = true;
        base = 0;
        if (++kk == group) {
          kb += group;
          kk = 0;
          load_headers();
        }
      }
    }
    shuffle_header();
    active = active && kb + kk < k1;
    load_round();
    win = __shfl_sync(kFullMask, h_win, kk, group);
  }
};

// out[rows[i], f] += sum over runs k in [run_ptr[i], run_ptr[i+1]) of
// (sum over slots s in [run_slot[k], run_slot[k] + run_len[k]) of
// vals[s] * b[tile_cw[s / edge_tile] * col_window + lcol[s], f]), for the
// BELL rows i in [i0, i0 + num_rows): the short rows.
// Lane l of a warp serves BELL row i0 + (warp * 32 + l) / group and, in
// feature slice blockIdx.y, the vectors v < NV at feature
// (blockIdx.y * group * NV + v * group + l % group) * VEC. A round is a
// slot a lane; its gathers go out kAhead slots at a time before their
// FMAs.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    bell_rows_kernel(const int* __restrict__ rows,
                     const int* __restrict__ run_ptr,
                     const int* __restrict__ run_slot,
                     const int* __restrict__ run_len,
                     const int* __restrict__ tile_cw,
                     const int* __restrict__ lcol,
                     const float* __restrict__ vals, const T* __restrict__ b,
                     float* __restrict__ out, int i0, int num_rows, int feat,
                     int edge_tile, int col_window, int group) {
  const int lane = threadIdx.x;
  const int li = lane & (group - 1);
  const int i = (blockIdx.x * kWarpsPerBlock + threadIdx.y) *
                    (kWarp / group) + lane / group;
  const bool has_row = i < num_rows;
  int f[NV];
  bool act[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    f[v] = ((blockIdx.y * NV + v) * group + li) * VEC;
    act[v] = has_row && f[v] < feat;  // VEC divides feat: the vector fits
  }
  // a lane past the last row keeps taking part in the warp's shuffles
  RunCursor cur{run_slot, run_len, tile_cw, lcol, vals, edge_tile,
                   col_window, group, li, has_row ? run_ptr[i0 + i + 1] : 0};
  cur.start(has_row ? run_ptr[i0 + i] : 0);
  // out's row, read now so that its latency hides behind the gathers
  constexpr int kW = out_width<T, VEC>();
  float* o = out + (has_row ? static_cast<int64_t>(rows[i0 + i]) : 0) * feat;
  float prior[NV][VEC], sum[NV][VEC], run[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int h = 0; h < VEC; h += kW) {
      Packed<float, kW> y;
      if (act[v])
        y = *reinterpret_cast<const Packed<float, kW>*>(o + f[v] + h);
#pragma unroll
      for (int q = 0; q < kW; ++q) prior[v][h + q] = act[v] ? y.v[q] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) sum[v][q] = run[v][q] = 0.f;
  }

  // every lane runs every trip (the warp's longest row decides), so the
  // full-mask shuffles never see a lane that has left
  while (__any_sync(kFullMask, cur.active)) {
    int n, round_win;
    bool run_done;
    cur.advance(n, round_win, run_done);
    const int n_warp = __reduce_max_sync(kFullMask, n);
    for (int j = 0; j < n_warp; j += kAhead) {
      Packed<T, VEC> x[kAhead][NV];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int r = __shfl_sync(kFullMask, cur.c, j + u, group);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (j + u < n && act[v])
            x[u][v] = *reinterpret_cast<const Packed<T, VEC>*>(
                b + static_cast<int64_t>(round_win + r) * feat + f[v]);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const float wu = __shfl_sync(kFullMask, cur.w, j + u, group);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (j + u < n && act[v]) {
#pragma unroll
            for (int q = 0; q < VEC; ++q)
              run[v][q] = fmaf(wu, to_float(x[u][v].v[q]), run[v][q]);
          }
      }
    }
    if (run_done) {
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          sum[v][q] += run[v][q];
          run[v][q] = 0.f;
        }
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!act[v]) continue;
#pragma unroll
    for (int h = 0; h < VEC; h += kW) {
      Packed<float, kW> y;
#pragma unroll
      for (int q = 0; q < kW; ++q) y.v[q] = prior[v][h + q] + sum[v][h + q];
      *reinterpret_cast<Packed<float, kW>*>(o + f[v] + h) = y;
    }
  }
  // launched to overlap the long rows' grid (programmatic dependent
  // launch): finish only after it, so that the stream's next work sees
  // both (a no-op otherwise)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The same sum for the long rows [i0, i0 + num_rows): one warp a row and
// feature slice blockIdx.y of 32 vectors of VEC elements (at most 4
// bytes), lane l at feature (blockIdx.y * 32 + l) * VEC. A round is 32
// slots of one run, and the rounds are pipelined: the next round's
// gathers are issued before this round's FMAs. A round's columns and
// values pass through shared memory, where every lane reads all 32 with 8
// 16-byte loads, so that its 32 gathers issue back to back (with a
// shuffle a slot, each gather waited on its shuffle; gathers issued a
// batch before their FMAs were interleaved with them by the compiler).
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarp * kLongWarps)
    bell_long_kernel(const int* __restrict__ rows,
                     const int* __restrict__ run_ptr,
                     const int* __restrict__ run_slot,
                     const int* __restrict__ run_len,
                     const int* __restrict__ tile_cw,
                     const int* __restrict__ lcol,
                     const float* __restrict__ vals, const T* __restrict__ b,
                     float* __restrict__ out, int i0, int num_rows, int feat,
                     int edge_tile, int col_window) {
  // a round's columns and values, two rounds in turn, a warp each
  __shared__ int4 s_col[kLongWarps][2][kWarp / 4];
  __shared__ float4 s_val[kLongWarps][2][kWarp / 4];
  // the short rows' grid may start now, beside this one
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x;
  // uniform to the compiler too, so the shuffles need no WARPSYNC
  const int wid = __shfl_sync(kFullMask, threadIdx.y, 0);
  const int i = blockIdx.x * kLongWarps + wid;
  if (i >= num_rows) return;
  const int f = (blockIdx.y * kWarp + lane) * VEC;
  const bool act = f < feat;  // VEC divides feat: the vector fits
  const T* bf = b + (act ? f : 0);
  RunCursor cur{run_slot, run_len, tile_cw, lcol, vals, edge_tile,
                   col_window, kWarp, lane, run_ptr[i0 + i + 1]};
  cur.start(run_ptr[i0 + i]);
  // out's row, read now so that its latency hides behind the gathers
  float* o = out + static_cast<int64_t>(rows[i0 + i]) * feat + f;
  Packed<float, VEC> prior;
  if (act) prior = *reinterpret_cast<const Packed<float, VEC>*>(o);
  float sum[VEC], run[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) sum[q] = run[q] = 0.f;

  // a round's columns c and values w (a slot a lane) into buffer `buf`
  auto stash = [&](int buf, int c, float w) {
    reinterpret_cast<int*>(s_col[wid][buf])[lane] = c;
    reinterpret_cast<float*>(s_val[wid][buf])[lane] = w;
    __syncwarp();
  };
  // the gathers of the n slots of the round in `buf`, window at `win`
  auto gather = [&](Packed<T, VEC>(&x)[kWarp], int buf, int win, int n) {
    int4 c4[kWarp / 4];
#pragma unroll
    for (int k = 0; k < kWarp / 4; ++k) c4[k] = s_col[wid][buf][k];
    const int* c = reinterpret_cast<const int*>(c4);
#pragma unroll
    for (int t = 0; t < kWarp; ++t)
      if (t < n && act)
        x[t] = *reinterpret_cast<const Packed<T, VEC>*>(
            bf + static_cast<int64_t>(win + c[t]) * feat);
  };
  int n, win, buf = 0;
  bool run_done;
  cur.advance(n, win, run_done);
  stash(buf, cur.c, cur.w);
  Packed<T, VEC> x[kWarp];
  gather(x, buf, win, n);
  while (__any_sync(kFullMask, n > 0)) {  // one row a warp: uniform
    // the next round: its columns and values are in registers already
    stash(buf ^ 1, cur.c_next, cur.w_next);
    Packed<T, VEC> y[kWarp];
    gather(y, buf ^ 1, cur.win,
           cur.active ? min(kWarp, cur.len - cur.base) : 0);
    float4 w4[kWarp / 4];
#pragma unroll
    for (int k = 0; k < kWarp / 4; ++k) w4[k] = s_val[wid][buf][k];
    const float* w = reinterpret_cast<const float*>(w4);
#pragma unroll
    for (int t = 0; t < kWarp; ++t)
      if (t < n && act) {
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          run[q] = fmaf(w[t], to_float(x[t].v[q]), run[q]);
      }
    if (run_done) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        sum[q] += run[q];
        run[q] = 0.f;
      }
    }
    cur.advance(n, win, run_done);
    buf ^= 1;
#pragma unroll
    for (int t = 0; t < kWarp; ++t) x[t] = y[t];
  }
  if (!act) return;
  Packed<float, VEC> out_v;
#pragma unroll
  for (int q = 0; q < VEC; ++q) out_v.v[q] = prior.v[q] + sum[q];
  *reinterpret_cast<Packed<float, VEC>*>(o) = out_v;
}

// The launch arguments shared by every path.
struct Args {
  const int *rows, *run_ptr, *run_slot, *run_len, *tile_cw, *lcol;
  const float* vals;
  const void* b;
  float* out;
  int feat, edge_tile, col_window;
  cudaStream_t stream;
};

// Whether B and out take vectors of VEC elements of T.
template <typename T, int VEC>
bool takes_vec(const Args& a) {
  return a.feat % VEC == 0 &&
         aligned(a.b, VEC * static_cast<int>(sizeof(T))) &&
         aligned(a.out, out_width<T, VEC>() * static_cast<int>(sizeof(float)));
}

// bell_rows_kernel over the BELL rows [i0, i0 + num_rows); with `overlap`,
// as a programmatic dependent launch that may run beside the grid before
// it in the stream (the long rows').
template <typename T, int VEC, int NV>
int launch_short_path(const Args& a, int i0, int num_rows, int group,
                      bool overlap) {
  const int per_block = kWarpsPerBlock * (kWarp / group);  // BELL rows
  const int slice = group * NV * VEC;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWarp, kWarpsPerBlock);
  cfg.gridDim = dim3((num_rows + per_block - 1) / per_block,
                     (a.feat + slice - 1) / slice);
  cfg.stream = a.stream;
  if (cfg.gridDim.y > 65535) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, bell_rows_kernel<T, VEC, NV>, a.rows,
                            a.run_ptr, a.run_slot, a.run_len, a.tile_cw,
                            a.lcol, a.vals, static_cast<const T*>(a.b),
                            a.out, i0, num_rows, a.feat, a.edge_tile,
                            a.col_window, group);
}

// The rows [i0, i0 + num_rows) on the group mapping (VEC, group, nv).
template <typename T, int VEC>
int launch_short(const Args& a, int i0, int num_rows, int group, int nv,
                 bool overlap) {
  if (nv < 1 || nv > max_vectors<T, VEC>() || !takes_vec<T, VEC>(a))
    return cudaErrorInvalidValue;
  if (num_rows == 0) return cudaSuccess;
  constexpr int kMax = max_vectors<T, VEC>();
  switch (nv) {
    case 1:
      return launch_short_path<T, VEC, 1>(a, i0, num_rows, group,
                                                overlap);
    case 2:
      return launch_short_path<T, VEC, 2>(a, i0, num_rows, group,
                                                overlap);
    default:
      if constexpr (kMax == 4) {
        if (nv == 3)
          return launch_short_path<T, VEC, 3>(a, i0, num_rows, group,
                                                overlap);
        return launch_short_path<T, VEC, 4>(a, i0, num_rows, group,
                                                overlap);
      }
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_short_vec(const Args& a, int i0, int num_rows, int vec, int group,
                     int nv, bool overlap) {
  switch (vec) {
    case 8:
      // only for 2-byte types (16 bytes / 2)
      if constexpr (sizeof(T) == 2)
        return launch_short<T, 8>(a, i0, num_rows, group, nv, overlap);
      return cudaErrorInvalidValue;
    case 4:
      return launch_short<T, 4>(a, i0, num_rows, group, nv, overlap);
    case 2:
      return launch_short<T, 2>(a, i0, num_rows, group, nv, overlap);
    case 1:
      return launch_short<T, 1>(a, i0, num_rows, group, nv, overlap);
    default:
      return cudaErrorInvalidValue;
  }
}

// bell_long_kernel over the rows [i0, i0 + num_rows).
template <typename T, int VEC>
int launch_long(const Args& a, int i0, int num_rows) {
  if (!takes_vec<T, VEC>(a)) return cudaErrorInvalidValue;
  if (num_rows == 0) return cudaSuccess;
  const dim3 block(kWarp, kLongWarps);
  const dim3 grid((num_rows + kLongWarps - 1) / kLongWarps,
                  (a.feat + kWarp * VEC - 1) / (kWarp * VEC));
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  bell_long_kernel<T, VEC><<<grid, block, 0, a.stream>>>(
      a.rows, a.run_ptr, a.run_slot, a.run_len, a.tile_cw, a.lcol, a.vals,
      static_cast<const T*>(a.b), a.out, i0, num_rows, a.feat, a.edge_tile,
      a.col_window);
  return cudaGetLastError();
}

template <typename T>
int launch(int device, const Args& a, int num_short, int num_long, int vec,
           int group, int nv, int long_vec) {
  if (num_short < 0 || num_long < 0 || a.feat <= 0 || a.edge_tile <= 0 ||
      a.col_window <= 0 ||
      (group != 4 && group != 8 && group != 16 && group != 32) ||
      long_vec * static_cast<int>(sizeof(T)) > 4)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // the long rows first: their chains of gathers are the longest
  int e = cudaErrorInvalidValue;
  if (long_vec == 1) e = launch_long<T, 1>(a, num_short, num_long);
  if constexpr (sizeof(T) == 2)
    if (long_vec == 2) e = launch_long<T, 2>(a, num_short, num_long);
  if (e != cudaSuccess) return e;
  return launch_short_vec<T>(a, 0, num_short, vec, group, nv, num_long > 0);
}

}  // namespace

extern "C" {

// out [*, F] fp32 (read and written in place): for each BELL row i <
// num_short + num_long, out[rows[i]] += the sum over its runs k in
// [run_ptr[i], run_ptr[i+1]) and slots s of run k (run_slot[k], run_len[k]
// of them) of vals[s] * B[tile_cw[s / edge_tile] * col_window + lcol[s]];
// every other row untouched. B [*, F] in `dtype` (0 fp32, 1 bf16). The
// short rows [0, num_short) run on the path (vec, group, nv) of
// `dg_csr_spmm` (`kernels/spmm_csr.py::spmm_path`: `vec` elements a load,
// dividing F, B and out aligned to the load's bytes and out to at least 4;
// `group` lanes a row, 4, 8, 16 or 32; `nv` vectors a lane); the long rows
// after them one warp a row and 32 vectors of `long_vec` elements (at most
// 4 bytes, dividing F, aligned likewise). Returns a cudaError_t.
int dg_spmm_bell(int dtype, int device, const int* rows, const int* run_ptr,
                 const int* run_slot, const int* run_len, const int* tile_cw,
                 const int* lcol, const float* vals, const void* b,
                 float* out, int num_short, int num_long, int feat,
                 int edge_tile, int col_window, int vec, int group, int nv,
                 int long_vec, void* stream) {
  const Args a{rows, run_ptr, run_slot, run_len, tile_cw, lcol, vals, b, out,
               feat, edge_tile, col_window,
               static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32)
    return launch<float>(device, a, num_short, num_long, vec, group, nv,
                         long_vec);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(device, a, num_short, num_long, vec, group,
                                 nv, long_vec);
  return cudaErrorInvalidValue;
}

}  // extern "C"
