/*
 * BER/throughput harness for the reference AWGN chain on the FRAMEWORK
 * EXTENSION codes (K=9 stack config, K=15 rate-1/2 and rate-1/4 16-QAM) —
 * the honest same-config C baseline for the bench rows that previously
 * divided by the K=3 core's rate (round-3 verdict, missing item 4).
 *
 * The reference decoders are generic over struct code_param
 * (common/include/code.h:9-19), so this driver feeds them extension
 * parameters mirroring convolutional_codes/models/codebook.py
 * (polynomials MSB-aligned like codebook.c:14-56; the tuned soft metric
 * weights are the framework's).  The reference ships no 16-point
 * constellation (constellations.c stops at 3 bits), so this file provides
 * its own get_constellation with the framework's Gray 16-QAM table
 * appended — do NOT link common/constellations.c.
 *
 * NOTE the reference parity routine is the effective/compat one
 * (SURVEY.md §2c): the C binary simulates the compat variant of these
 * codes.  The framework-side ratio rows therefore measure
 * code.replace(parity=PARITY_COMPAT) so both sides run the identical
 * effective code.
 *
 * Build: gcc -O3 harness_ber_awgn_ext.c common/{codebook,encoder,mapper,
 *        demapper,gaussian}.c AWGN-channel/{stack|fano}-decoder.c -lm
 * Usage: harness_ber_awgn_ext <code_idx> <nblocks> <seed> <ebn0_db_x100>
 *        code_idx 0-5 = reference codebook; 6 = k9-r12, 7 = k15-r12,
 *        8 = k15-r14-16qam
 * Output: "<bits> <bit_errors> <frame_errors>"
 */
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>
#include <math.h>

#include "code.h"
#include "codebook.h"
#include "encoder.h"
#include "mapper.h"
#include "demapper.h"
#include "decoder.h"
#include "gaussian.h"

/* ---- constellations: reference tables + framework Gray 16-QAM -------- */

static float c_1[] = {
     0.707107f,  0.707107f,
    -0.707107f, -0.707107f,
};
static float c_2[] = {
     0.707107f,  0.707107f,
     0.707107f, -0.707107f,
    -0.707107f,  0.707107f,
    -0.707107f, -0.707107f,
};
static float c_3[] = {
     0.408248f,  0.408248f,  0.408248f,  1.224745f,
    -0.408248f,  0.408248f, -1.224745f,  0.408248f,
     0.408248f, -0.408248f,  1.224745f, -0.408248f,
    -0.408248f, -0.408248f, -0.408248f, -1.224745f,
};
/* framework Gray 16-QAM (models/constellations.py), unit power */
static float c_4[] = {
    -0.9486833f, -0.9486833f,
    -0.9486833f, -0.31622776f,
    -0.9486833f,  0.9486833f,
    -0.9486833f,  0.31622776f,
    -0.31622776f, -0.9486833f,
    -0.31622776f, -0.31622776f,
    -0.31622776f,  0.9486833f,
    -0.31622776f,  0.31622776f,
     0.9486833f, -0.9486833f,
     0.9486833f, -0.31622776f,
     0.9486833f,  0.9486833f,
     0.9486833f,  0.31622776f,
     0.31622776f, -0.9486833f,
     0.31622776f, -0.31622776f,
     0.31622776f,  0.9486833f,
     0.31622776f,  0.31622776f,
};
static float* constellations[] = { NULL, c_1, c_2, c_3, c_4 };

float* get_constellation(uint8_t num_bits) {
    return constellations[num_bits];
}

/* ---- extension codes (codebook.py extensions; MSB-aligned polys) ----- */

/* K=9 (561, 753 octal) */
static uint64_t polys_k9[] = {
    0x171ULL << 55,   /* 0o561 */
    0x1EBULL << 55,   /* 0o753 */
};
/* K=15 (42554, 77304 octal) */
static uint64_t polys_k15[] = {
    0x456CULL << 49,  /* 0o42554 */
    0x7EC4ULL << 49,  /* 0o77304 */
};
/* K=15 rate 1/4 (42554, 77304, 56043, 61175 octal) */
static uint64_t polys_k15_r14[] = {
    0x456CULL << 49,  /* 0o42554 */
    0x7EC4ULL << 49,  /* 0o77304 */
    0x5C23ULL << 49,  /* 0o56043 */
    0x627DULL << 49,  /* 0o61175 */
};
static int32_t metrics_ext[] = {1, -30};
static int32_t fmetrics_ext[] = {1, -48};

static void get_code_ext(int idx, struct code_param* p) {
    if (idx < 6) {
        get_code((uint8_t)idx, p);
        return;
    }
    p->bit_metrics = metrics_ext;
    p->fano_bit_metrics = fmetrics_ext;
    p->userdata = NULL;
    switch (idx) {
    case 6:  /* k9-r12 */
        p->symlen_out = 2; p->constr_len = 9; p->block_len = 100;
        p->polynomials = polys_k9;
        p->metric_weight = -16.0f; p->fano_metric_weight = -110.0f;
        break;
    case 7:  /* k15-r12 */
        p->symlen_out = 2; p->constr_len = 15; p->block_len = 200;
        p->polynomials = polys_k15;
        p->metric_weight = -16.0f; p->fano_metric_weight = -110.0f;
        break;
    case 8:  /* k15-r14-16qam */
        p->symlen_out = 4; p->constr_len = 15; p->block_len = 200;
        p->polynomials = polys_k15_r14;
        p->metric_weight = -1.5f; p->fano_metric_weight = -1.5f;
        break;
    default:
        fprintf(stderr, "bad code idx %d\n", idx);
        exit(2);
    }
}

/* ---- pipeline wiring (identical to harness_ber_awgn.c) --------------- */

static struct mapper* map;
static struct demapper* dem;
static struct decoder* dec;
static float scaling;

static int enc_cb(uint8_t* data, uint8_t len, void* ud) {
    (void)ud;
    mapper_input(map, data, len);
    return -1;
}

static int map_cb(float* data, uint8_t len, void* ud) {
    /* len counts FLOATS (the mapper emits one symbol per callback with
     * len == 2), exactly like the reference driver's noise loop
     * (AWGN-channel/main.c:100-102) — an earlier harness revision looped
     * 2*len and wrote past the mapper's 2-float buffer. */
    (void)ud;
    for (int i = 0; i < (int)len; ++i) data[i] += scaling * gengauss();
    demapper_input(dem, data, len);
    return -1;
}

static int dem_cb(float* data, uint8_t len, void* ud) {
    (void)ud;
    decoder_input(dec, data, len);
    return -1;
}

static uint8_t dec_bits[64];
static int dec_cb(uint8_t* data, uint8_t len, void* ud) {
    (void)ud;
    for (int i = 0; i < (len + 7) / 8; ++i) dec_bits[i] = data[i];
    return -1;
}

int main(int argc, char** argv) {
    if (argc < 5) return 2;
    int code_idx = atoi(argv[1]);
    long nblocks = atol(argv[2]);
    unsigned seed = (unsigned)strtoul(argv[3], NULL, 10);
    double ebn0_db = atol(argv[4]) / 100.0;
    srand(seed);

    struct code_param param;
    get_code_ext(code_idx, &param);
    param.userdata = NULL;

    /* per-component sigma, Eb = Es (AWGN-channel/main.c:153-161) */
    scaling = (float)(sqrt(0.5) * pow(10.0, -ebn0_db / 20.0));

    struct encoder* enc = encoder_create();
    encoder_init(enc, &param);
    encoder_register_callback(enc, enc_cb);
    map = mapper_create();
    mapper_init(map, &param);
    mapper_register_callback(map, map_cb);
    dem = demapper_create();
    demapper_init(dem, &param);
    demapper_register_callback(dem, dem_cb);
    dec = decoder_create();
    decoder_init(dec, &param);
    decoder_register_callback(dec, dec_cb);

    int L = param.block_len;
    int nbytes = (L + 7) / 8;
    uint8_t packed[64];
    long long bits = 0, errs = 0, ferrs = 0;

    for (long b = 0; b < nblocks; ++b) {
        for (int i = 0; i < nbytes; ++i) packed[i] = (uint8_t)(rand() % 256);
        encoder_input(enc, packed, (uint8_t)L);
        long long before = errs;
        for (int i = 0; i < L; ++i) {
            int tx = (packed[i / 8] >> (7 - (i % 8))) & 1;
            int rxb = (dec_bits[i / 8] >> (7 - (i % 8))) & 1;
            if (tx != rxb) ++errs;
        }
        if (errs != before) ++ferrs;
        bits += L;
    }
    printf("%lld %lld %lld\n", bits, errs, ferrs);
    return 0;
}
