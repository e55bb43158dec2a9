// A warp's real FFT in shared memory, shared by fused_rows.cu
// (fft_rows_kernel) and log_mel.cu (log_mel_fft_kernel).
//
// The caller packs an N-point real frame x (already windowed) as the
// M = N/2 complex points z[i] = x[2i] + i x[2i+1] into one re/im buffer pair
// (re [M] | im [M]) of the warp. fft_passes runs the M-point complex FFT as
// radix-4 Stockham passes (a radix-2 pass last where log2 M is odd) between
// that pair and a second one, separated by __syncwarp only; split_power then
// forms X[k] = E[k] + W_N^k O[k] for k = 0..M, E = (Z[k] + conj Z[M-k]) / 2,
// O = (Z[k] - conj Z[M-k]) / 2i, and writes |X[k]|^2. Twiddles
// tw[e] = W_N^e = (cos, -sin)(2 pi e / N), e < N, are f32 values computed in
// float64 on the host. Every operation is f32.

#pragma once

#include <cuda_runtime.h>

// One pass of the Stockham FFT over the warp's m points: sub-transforms of
// length ns become length ns * R. Reads (sr, si), writes (dr, di) in natural
// order; tw[e] = W_n^e with n = 2m.
template <int R>
__device__ __forceinline__ void stockham_pass(const float* sr, const float* si, float* dr, float* di, int m, int ns,
                                              const float2* tw, int lane) {
    const int q = m / R;
    const int step = 2 * m / (R * ns);  // W_{R ns}^{r k} = W_n^{r k step}
    for (int j = lane; j < q; j += 32) {
        const int k = j & (ns - 1);
        float ar[R], ai[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            ar[r] = sr[j + r * q];
            ai[r] = si[j + r * q];
        }
#pragma unroll
        for (int r = 1; r < R; ++r) {
            const float2 w = tw[r * k * step];
            const float xr = ar[r] * w.x - ai[r] * w.y;
            ai[r] = ar[r] * w.y + ai[r] * w.x;
            ar[r] = xr;
        }
        const int o = (j - k) * R + k;
        if (R == 4) {  // DFT_4 with W_4 = -i
            const float t0r = ar[0] + ar[2], t0i = ai[0] + ai[2];
            const float t1r = ar[0] - ar[2], t1i = ai[0] - ai[2];
            const float t2r = ar[1] + ar[3], t2i = ai[1] + ai[3];
            const float t3r = ar[1] - ar[3], t3i = ai[1] - ai[3];
            dr[o] = t0r + t2r;
            di[o] = t0i + t2i;
            dr[o + ns] = t1r + t3i;
            di[o + ns] = t1i - t3r;
            dr[o + 2 * ns] = t0r - t2r;
            di[o + 2 * ns] = t0i - t2i;
            dr[o + 3 * ns] = t1r - t3i;
            di[o + 3 * ns] = t1i + t3r;
        } else {
            dr[o] = ar[0] + ar[1];
            di[o] = ai[0] + ai[1];
            dr[o + ns] = ar[0] - ar[1];
            di[o + ns] = ai[0] - ai[1];
        }
    }
}

// The m-point complex FFT of the points in buf0 (re [m] | im [m]), using buf1
// as the other buffer of the ping-pong; returns the buffer that holds the
// result. Ends with a __syncwarp.
__device__ __forceinline__ float* fft_passes(float* buf0, float* buf1, int m, const float2* tw, int lane) {
    float *sr = buf0, *dr = buf1;
    int ns = 1;
    for (; ns * 4 <= m; ns *= 4) {
        stockham_pass<4>(sr, sr + m, dr, dr + m, m, ns, tw, lane);
        __syncwarp();
        float* t = sr;
        sr = dr;
        dr = t;
    }
    if (ns < m) {
        stockham_pass<2>(sr, sr + m, dr, dr + m, m, ns, tw, lane);
        __syncwarp();
        float* t = sr;
        sr = dr;
        dr = t;
    }
    return sr;
}

// The split post-pass: pw[k] = |E + W_n^k O|^2 for k = 0..m from the FFT in
// sr (re [m] | im [m]); pw is the other buffer of the pair (pw[m] is the first
// float of its im half, no longer needed). The caller syncs the warp after.
__device__ __forceinline__ void split_power(const float* sr, float* pw, int m, int n, const float2* tw, int lane) {
    const float* si = sr + m;
    for (int k = lane; k <= m; k += 32) {
        const int a = k & (m - 1), b = (m - k) & (m - 1);
        const float zr = sr[a], zi = si[a], cr = sr[b], ci = -si[b];
        const float er = 0.5f * (zr + cr), ei = 0.5f * (zi + ci);
        const float orr = 0.5f * (zi - ci), oi = -0.5f * (zr - cr);
        const float2 w = tw[k & (n - 1)];
        const float xr = er + (w.x * orr - w.y * oi);
        const float xi = ei + (w.x * oi + w.y * orr);
        pw[k] = xr * xr + xi * xi;
    }
}
