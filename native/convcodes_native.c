/*
 * Native host-side runtime: clean-room C implementation of the framework's
 * behavioral contract (encoder + block Viterbi/stack/Fano decoders),
 * matching the C reference bit-for-bit (semantics documented in SURVEY.md;
 * reference: common/encoder.c, AWGN-channel/{viterbi,stack,fano}-decoder.c
 * and the binary-symmetric-channel twins — reimplemented, not copied).
 *
 * Purpose in the framework:
 *   - fast fuzz oracle for the JAX/Pallas decoders (tests/test_native.py
 *     cross-checks millions of trellis steps beyond the pinned goldens),
 *   - host-side fallback decoder for environments without an accelerator.
 *
 * Built as a shared library on first use and bound with ctypes by
 * convolutional_codes/utils/native.py.  Batch-level APIs operate on
 * unpacked bit/symbol arrays to mirror the device layout.
 */

#include <stdint.h>
#include <string.h>
#include <math.h>
#include <stdlib.h>

#define MAX_POLYS 8

typedef struct {
    int32_t symlen_out;
    int32_t constraint_length;
    int32_t block_length;      /* info bits per block */
    int32_t compat_parity;     /* 1 = reference effective parity */
    uint32_t polynomials[MAX_POLYS]; /* low-bit form, newest tap at K-1 */
} cc_params;

/* Quirk mask in low-bit register space (SURVEY.md §2c): 64-bit positions
 * {4,12,...,60} shifted into the K-bit register. */
static uint32_t quirk_mask_low(int k) {
    uint32_t m = 0;
    for (int j = 4; j <= 60; j += 8) {
        int b = j - 64 + k;
        if (b >= 0 && b < k) m |= (uint32_t)1u << b;
    }
    return m;
}

static inline int parity32(uint32_t x) {
    return __builtin_parity(x);
}

/* Expected symbol for register r (K bits, newest input at bit K-1). */
static inline int expected_symbol(const cc_params* p, uint32_t quirk,
                                  uint32_t r) {
    int sym = 0;
    for (int n = 0; n < p->symlen_out; ++n) {
        uint32_t x = r & p->polynomials[n];
        int bit = parity32(x);
        if (p->compat_parity && parity32(x & quirk)) bit = 0;
        sym = (sym << 1) | bit;
    }
    return sym;
}

/* ---- encoder -------------------------------------------------------- */

/* bits_in: [nblocks][block_length] (0/1 int8); syms_out: [nblocks][T] int32
 * with T = block_length + K - 1 (auto tail termination). */
void cc_encode_blocks(const cc_params* p, const int8_t* bits_in,
                      int32_t* syms_out, int64_t nblocks) {
    const int K = p->constraint_length;
    const int L = p->block_length;
    const int T = L + K - 1;
    const uint32_t quirk = quirk_mask_low(K);
    for (int64_t b = 0; b < nblocks; ++b) {
        const int8_t* bits = bits_in + b * L;
        int32_t* out = syms_out + b * T;
        uint32_t reg = 0;
        for (int t = 0; t < T; ++t) {
            int bit = (t < L) ? bits[t] : 0;
            reg = (reg >> 1) | ((uint32_t)bit << (K - 1));
            out[t] = expected_symbol(p, quirk, reg);
        }
    }
}

/* ---- Viterbi -------------------------------------------------------- */

#define HARD_SAT 0xFF00

/* Soft decode: dists [nblocks][T][2^m] float32 → bits_out [nblocks][L]. */
void cc_viterbi_soft_blocks(const cc_params* p, const float* dists,
                            int8_t* bits_out, int64_t nblocks) {
    const int K = p->constraint_length;
    const int L = p->block_length;
    const int T = L + K - 1;
    const int S = 1 << (K - 1);
    const int M = 1 << p->symlen_out;
    const uint32_t quirk = quirk_mask_low(K);

    float* metrics = malloc(sizeof(float) * S);
    float* newm = malloc(sizeof(float) * S);
    uint8_t* dec = malloc((size_t)T * S);      /* chosen predecessor parity */
    int* esym = malloc(sizeof(int) * S * 2);   /* esym[state][input] */
    for (int s = 0; s < S; ++s)
        for (int i = 0; i < 2; ++i)
            esym[2 * s + i] = expected_symbol(
                p, quirk, (uint32_t)s | ((uint32_t)i << (K - 1)));

    for (int64_t b = 0; b < nblocks; ++b) {
        const float* d = dists + (size_t)b * T * M;
        for (int s = 0; s < S; ++s) metrics[s] = INFINITY;
        metrics[0] = 0.0f;
        for (int t = 0; t < T; ++t) {
            const float* row = d + (size_t)t * M;
            for (int ns = 0; ns < S; ++ns) {
                int inp = ns >> (K - 2);
                int p0 = (ns & ((S >> 1) - 1)) << 1;
                float c0 = metrics[p0] + row[esym[2 * p0 + inp]];
                float c1 = metrics[p0 + 1] + row[esym[2 * (p0 + 1) + inp]];
                int pick1 = c1 < c0;             /* strict: ties → even pred */
                newm[ns] = pick1 ? c1 : c0;
                dec[(size_t)t * S + ns] = (uint8_t)pick1;
            }
            memcpy(metrics, newm, sizeof(float) * S);
        }
        int cur = 0;
        float best = INFINITY;
        for (int s = 0; s < S; ++s)
            if (metrics[s] < best) { best = metrics[s]; cur = s; }
        int8_t* out = bits_out + b * L;
        for (int t = T - 1; t >= 0; --t) {
            int bit = cur >> (K - 2);
            int prev = ((cur & ((S >> 1) - 1)) << 1) | dec[(size_t)t * S + cur];
            if (t < L) out[t] = (int8_t)bit;
            cur = prev;
        }
    }
    free(metrics); free(newm); free(dec); free(esym);
}

/* Hard decode: rx [nblocks][T] int32 symbols → bits_out [nblocks][L],
 * path_metric_out [nblocks] int32 (saturating 0xFF00 arithmetic). */
void cc_viterbi_hard_blocks(const cc_params* p, const int32_t* rx,
                            int8_t* bits_out, int32_t* path_metric_out,
                            int64_t nblocks) {
    const int K = p->constraint_length;
    const int L = p->block_length;
    const int T = L + K - 1;
    const int S = 1 << (K - 1);
    const uint32_t quirk = quirk_mask_low(K);

    int32_t* metrics = malloc(sizeof(int32_t) * S);
    int32_t* newm = malloc(sizeof(int32_t) * S);
    uint8_t* dec = malloc((size_t)T * S);
    int* esym = malloc(sizeof(int) * S * 2);
    for (int s = 0; s < S; ++s)
        for (int i = 0; i < 2; ++i)
            esym[2 * s + i] = expected_symbol(
                p, quirk, (uint32_t)s | ((uint32_t)i << (K - 1)));

    for (int64_t b = 0; b < nblocks; ++b) {
        const int32_t* r = rx + (size_t)b * T;
        for (int s = 0; s < S; ++s) metrics[s] = HARD_SAT;
        metrics[0] = 0;
        for (int t = 0; t < T; ++t) {
            int sym = r[t];
            for (int ns = 0; ns < S; ++ns) {
                int inp = ns >> (K - 2);
                int p0 = (ns & ((S >> 1) - 1)) << 1;
                int32_t c0 = metrics[p0]
                    + __builtin_popcount((unsigned)(esym[2 * p0 + inp] ^ sym));
                int32_t c1 = metrics[p0 + 1]
                    + __builtin_popcount((unsigned)(esym[2 * (p0 + 1) + inp] ^ sym));
                if (c0 > HARD_SAT) c0 = HARD_SAT;
                if (c1 > HARD_SAT) c1 = HARD_SAT;
                int pick1 = c1 < c0;
                newm[ns] = pick1 ? c1 : c0;
                dec[(size_t)t * S + ns] = (uint8_t)pick1;
            }
            memcpy(metrics, newm, sizeof(int32_t) * S);
        }
        int cur = 0;
        int32_t best = HARD_SAT;
        for (int s = 0; s < S; ++s)
            if (metrics[s] < best) { best = metrics[s]; cur = s; }
        path_metric_out[b] = best;
        int8_t* out = bits_out + b * L;
        for (int t = T - 1; t >= 0; --t) {
            int bit = cur >> (K - 2);
            int prev = ((cur & ((S >> 1) - 1)) << 1) | dec[(size_t)t * S + cur];
            if (t < L) out[t] = (int8_t)bit;
            cur = prev;
        }
    }
    free(metrics); free(newm); free(dec); free(esym);
}

/* ---- Stack decoder ---------------------------------------------------- */
/* Behavioral spec: tests/golden_model.py _stack_decode (cross-validated
 * against AWGN-channel/stack-decoder.c:200-276 and the BSC twin).  A fixed
 * 64-entry path stack; each round the best path (ties -> lowest index)
 * extends until it has consumed the newly available symbol; duplicates
 * overwrite the worst path (ties -> lowest index) once the stack is full. */

#define STACK_DEPTH 64

typedef struct { int32_t nii; uint32_t state; float metric; } sp_soft;
typedef struct { int32_t nii; uint32_t state; int32_t metric; } sp_hard;

/* argmax, ties -> lowest index (Python max over (metric, -k)) */
#define DEF_ARGBEST(NAME, TY, CMP)                        \
    static int NAME(const TY* a, int n) {                 \
        int b = 0;                                        \
        for (int i = 1; i < n; ++i)                       \
            if (a[i].metric CMP a[b].metric) b = i;       \
        return b;                                         \
    }
DEF_ARGBEST(argmax_soft, sp_soft, >)
DEF_ARGBEST(argmin_soft, sp_soft, <)
DEF_ARGBEST(argmax_hard, sp_hard, >)
DEF_ARGBEST(argmin_hard, sp_hard, <)

/* Soft: dists [nblocks][T][2^m] f32, tm = 1 + metric_weight*dist (f32 each
 * step, accumulation order as the spec).  bits_out [nblocks][L]. */
void cc_stack_soft_blocks(const cc_params* p, const float* dists,
                          float metric_weight, int8_t* bits_out,
                          int64_t nblocks) {
    const int K = p->constraint_length;
    const int L = p->block_length;
    const int T = L + K - 1;
    const int M = 1 << p->symlen_out;
    const uint32_t quirk = quirk_mask_low(K);
    sp_soft paths[STACK_DEPTH];
    uint8_t* bits = malloc((size_t)STACK_DEPTH * T);

    for (int64_t blk = 0; blk < nblocks; ++blk) {
        const float* d = dists + (size_t)blk * T * M;
        int np = 1;
        paths[0].nii = 0; paths[0].state = 0; paths[0].metric = 0.0f;
        memset(bits, 0, (size_t)STACK_DEPTH * T);
        int cur = 0;
        for (int widx = 1; widx <= T; ++widx) {
            cur = argmax_soft(paths, np);
            while (paths[cur].nii != widx) {
                sp_soft* pp = &paths[cur];
                const float* row = d + (size_t)pp->nii * M;
                uint32_t ns[2]; float tm[2];
                for (int i = 0; i < 2; ++i) {
                    uint32_t reg = pp->state | ((uint32_t)i << (K - 1));
                    int es = expected_symbol(p, quirk, reg);
                    ns[i] = reg >> 1;
                    tm[i] = 1.0f + metric_weight * row[es];
                }
                int newi;
                if (np < STACK_DEPTH) newi = np++;
                else newi = argmin_soft(paths, np);
                sp_soft* q = &paths[newi];
                q->nii = pp->nii; q->state = pp->state; q->metric = pp->metric;
                if (newi != cur) memcpy(bits + (size_t)newi * T,
                                        bits + (size_t)cur * T, T);
                /* extend original with input 0, duplicate with input 1 —
                 * sequential so the alias case (newi == cur) matches the
                 * spec's object semantics exactly */
                { int oi = pp->nii; pp->nii += 1; pp->state = ns[0];
                  pp->metric = pp->metric + tm[0];
                  bits[(size_t)cur * T + oi] = 0; }
                { int oi = q->nii; q->nii += 1; q->state = ns[1];
                  q->metric = q->metric + tm[1];
                  bits[(size_t)newi * T + oi] = 1; }
                cur = argmax_soft(paths, np);
            }
        }
        int8_t* out = bits_out + blk * L;
        for (int t = 0; t < L; ++t) out[t] = (int8_t)bits[(size_t)cur * T + t];
    }
    free(bits);
}

/* Hard: rx [nblocks][T] int32 symbols, tm = h*bm1 + (m-h)*bm0. */
void cc_stack_hard_blocks(const cc_params* p, const int32_t* rx,
                          int32_t bm0, int32_t bm1, int8_t* bits_out,
                          int64_t nblocks) {
    const int K = p->constraint_length;
    const int L = p->block_length;
    const int T = L + K - 1;
    const int m = p->symlen_out;
    const uint32_t quirk = quirk_mask_low(K);
    sp_hard paths[STACK_DEPTH];
    uint8_t* bits = malloc((size_t)STACK_DEPTH * T);

    for (int64_t blk = 0; blk < nblocks; ++blk) {
        const int32_t* r = rx + (size_t)blk * T;
        int np = 1;
        paths[0].nii = 0; paths[0].state = 0; paths[0].metric = 0;
        memset(bits, 0, (size_t)STACK_DEPTH * T);
        int cur = 0;
        for (int widx = 1; widx <= T; ++widx) {
            cur = argmax_hard(paths, np);
            while (paths[cur].nii != widx) {
                sp_hard* pp = &paths[cur];
                int sym = r[pp->nii];
                uint32_t ns[2]; int32_t tm[2];
                for (int i = 0; i < 2; ++i) {
                    uint32_t reg = pp->state | ((uint32_t)i << (K - 1));
                    int es = expected_symbol(p, quirk, reg);
                    int h = __builtin_popcount((unsigned)(es ^ sym));
                    ns[i] = reg >> 1;
                    tm[i] = h * bm1 + (m - h) * bm0;
                }
                int newi;
                if (np < STACK_DEPTH) newi = np++;
                else newi = argmin_hard(paths, np);
                sp_hard* q = &paths[newi];
                q->nii = pp->nii; q->state = pp->state; q->metric = pp->metric;
                if (newi != cur) memcpy(bits + (size_t)newi * T,
                                        bits + (size_t)cur * T, T);
                { int oi = pp->nii; pp->nii += 1; pp->state = ns[0];
                  pp->metric += tm[0]; bits[(size_t)cur * T + oi] = 0; }
                { int oi = q->nii; q->nii += 1; q->state = ns[1];
                  q->metric += tm[1]; bits[(size_t)newi * T + oi] = 1; }
                cur = argmax_hard(paths, np);
            }
        }
        int8_t* out = bits_out + blk * L;
        for (int t = 0; t < L; ++t) out[t] = (int8_t)bits[(size_t)cur * T + t];
    }
    free(bits);
}


/* ---- Fano decoder ------------------------------------------------------ */
/* Behavioral spec: tests/golden_model.py _fano_decode (cross-validated
 * against AWGN-channel/fano-decoder.c:150-265 and the BSC twin): the
 * threshold walk with delta tightening/lowering, best-branch-first node
 * ordering (strict compare), per-block timeout = timeout_per_bit * T, and
 * the "ignore" latch once the budget is exhausted mid-stream.
 *
 * Soft metrics are float (tm = 1 + fano_metric_weight * dist, f32 ops in
 * spec order); hard metrics are int (tm = h*bm1 + (m-h)*bm0).  The two
 * variants are explicit functions — same walk, different metric type. */

typedef struct {
    uint32_t state, succ[2];
    float metric, tm[2];
    int32_t selected, decoded;
} fnode_soft;

typedef struct {
    uint32_t state, succ[2];
    int32_t metric, tm[2];
    int32_t selected, decoded;
} fnode_hard;

static void fano_compute_soft(const cc_params* p, uint32_t quirk, int K,
                              fnode_soft* n, const float* row, float mw) {
    uint32_t sc[2]; float tv[2];
    for (int i = 0; i < 2; ++i) {
        uint32_t reg = n->state | ((uint32_t)i << (K - 1));
        int es = expected_symbol(p, quirk, reg);
        sc[i] = reg >> 1;
        tv[i] = 1.0f + mw * row[es];
    }
    n->decoded = 0; n->selected = 0;
    int swap = tv[0] < tv[1];          /* strict: best branch first */
    n->succ[0] = sc[swap]; n->succ[1] = sc[1 - swap];
    n->tm[0] = tv[swap];   n->tm[1] = tv[1 - swap];
    n->decoded = swap;
}

static void fano_compute_hard(const cc_params* p, uint32_t quirk, int K,
                              fnode_hard* n, int sym, int32_t bm0,
                              int32_t bm1) {
    const int m = p->symlen_out;
    uint32_t sc[2]; int32_t tv[2];
    for (int i = 0; i < 2; ++i) {
        uint32_t reg = n->state | ((uint32_t)i << (K - 1));
        int es = expected_symbol(p, quirk, reg);
        int h = __builtin_popcount((unsigned)(es ^ sym));
        sc[i] = reg >> 1;
        tv[i] = h * bm1 + (m - h) * bm0;
    }
    n->decoded = 0; n->selected = 0;
    int swap = tv[0] < tv[1];
    n->succ[0] = sc[swap]; n->succ[1] = sc[1 - swap];
    n->tm[0] = tv[swap];   n->tm[1] = tv[1 - swap];
    n->decoded = swap;
}

/* Soft: dists [nblocks][T][2^m] f32 → bits_out [nblocks][L],
 * timeout_out [nblocks] (1 = budget exhausted before the frame end). */
void cc_fano_soft_blocks(const cc_params* p, const float* dists,
                         float metric_weight, float delta,
                         int32_t timeout_per_bit, int8_t* bits_out,
                         int8_t* timeout_out, int64_t nblocks) {
    const int K = p->constraint_length;
    const int L = p->block_length;
    const int T = L + K - 1;
    const int M = 1 << p->symlen_out;
    const uint32_t quirk = quirk_mask_low(K);
    fnode_soft* nodes = malloc(sizeof(fnode_soft) * T);

    for (int64_t blk = 0; blk < nblocks; ++blk) {
        const float* d = dists + (size_t)blk * T * M;
        memset(nodes, 0, sizeof(fnode_soft) * T);
        float threshold = 0.0f;
        int64_t timeout = (int64_t)timeout_per_bit * T;
        int cur = 0, ignore = 0, done = 0, tflag = 0;
        for (int received = 1; received <= T && !done; ++received) {
            if (ignore) continue;
            fano_compute_soft(p, quirk, K, &nodes[cur],
                              d + (size_t)cur * M, metric_weight);
            int moved_out = 0;
            while (timeout != 0) {
                timeout--;
                fnode_soft* n = &nodes[cur];
                float ms = n->metric + n->tm[n->selected];
                if (ms >= threshold) {
                    if (n->metric < threshold + delta)
                        while (ms >= threshold + delta)
                            threshold = threshold + delta;
                    int nxt = cur + 1;
                    if (nxt == T) { done = 1; break; }
                    nodes[nxt].state = n->succ[n->selected];
                    nodes[nxt].metric = ms;
                    cur = nxt;
                    if (cur == received) { moved_out = 1; break; }
                    fano_compute_soft(p, quirk, K, &nodes[cur],
                                      d + (size_t)cur * M, metric_weight);
                } else {
                    for (;;) {
                        if (cur == 0 || nodes[cur - 1].metric < threshold) {
                            threshold = threshold - delta;
                            if (nodes[cur].selected != 0) {
                                nodes[cur].selected = 0;
                                nodes[cur].decoded ^= 1;
                            }
                            break;
                        }
                        cur--;
                        if (nodes[cur].selected == 0) {
                            nodes[cur].selected = 1;
                            nodes[cur].decoded ^= 1;
                            break;
                        }
                    }
                }
            }
            if (done) break;
            if (!moved_out && timeout == 0) {
                if (received == T) { tflag = 1; break; }
                ignore = 1;
            }
        }
        if (!done && !tflag) tflag = ignore;
        int8_t* out = bits_out + blk * L;
        for (int t = 0; t < L; ++t) out[t] = (int8_t)nodes[t].decoded;
        timeout_out[blk] = (int8_t)tflag;
    }
    free(nodes);
}

/* Hard: rx [nblocks][T] int32 symbols, integer metric walk. */
void cc_fano_hard_blocks(const cc_params* p, const int32_t* rx,
                         int32_t bm0, int32_t bm1, int32_t delta,
                         int32_t timeout_per_bit, int8_t* bits_out,
                         int8_t* timeout_out, int64_t nblocks) {
    const int K = p->constraint_length;
    const int L = p->block_length;
    const int T = L + K - 1;
    const uint32_t quirk = quirk_mask_low(K);
    fnode_hard* nodes = malloc(sizeof(fnode_hard) * T);

    for (int64_t blk = 0; blk < nblocks; ++blk) {
        const int32_t* r = rx + (size_t)blk * T;
        memset(nodes, 0, sizeof(fnode_hard) * T);
        int32_t threshold = 0;
        int64_t timeout = (int64_t)timeout_per_bit * T;
        int cur = 0, ignore = 0, done = 0, tflag = 0;
        for (int received = 1; received <= T && !done; ++received) {
            if (ignore) continue;
            fano_compute_hard(p, quirk, K, &nodes[cur], r[cur], bm0, bm1);
            int moved_out = 0;
            while (timeout != 0) {
                timeout--;
                fnode_hard* n = &nodes[cur];
                int32_t ms = n->metric + n->tm[n->selected];
                if (ms >= threshold) {
                    if (n->metric < threshold + delta)
                        while (ms >= threshold + delta)
                            threshold = threshold + delta;
                    int nxt = cur + 1;
                    if (nxt == T) { done = 1; break; }
                    nodes[nxt].state = n->succ[n->selected];
                    nodes[nxt].metric = ms;
                    cur = nxt;
                    if (cur == received) { moved_out = 1; break; }
                    fano_compute_hard(p, quirk, K, &nodes[cur], r[cur],
                                      bm0, bm1);
                } else {
                    for (;;) {
                        if (cur == 0 || nodes[cur - 1].metric < threshold) {
                            threshold = threshold - delta;
                            if (nodes[cur].selected != 0) {
                                nodes[cur].selected = 0;
                                nodes[cur].decoded ^= 1;
                            }
                            break;
                        }
                        cur--;
                        if (nodes[cur].selected == 0) {
                            nodes[cur].selected = 1;
                            nodes[cur].decoded ^= 1;
                            break;
                        }
                    }
                }
            }
            if (done) break;
            if (!moved_out && timeout == 0) {
                if (received == T) { tflag = 1; break; }
                ignore = 1;
            }
        }
        if (!done && !tflag) tflag = ignore;
        int8_t* out = bits_out + blk * L;
        for (int t = 0; t < L; ++t) out[t] = (int8_t)nodes[t].decoded;
        timeout_out[blk] = (int8_t)tflag;
    }
    free(nodes);
}
