// Keccak-f[1600] and the STROBE-128 operations of merlin transcripts, for
// the host: the fast path of the port's host transcripts
// (quisquis_tpu_torch/ops/host_strobe.py, chosen by accounts/transcript.py
// when it loads). Same bytes as the pure-Python Strobe128 of ops/strobe.py,
// which stays as its plain version (tests/test_torch_host_strobe.py).
//
// Built with g++ at first use into build/ (ops/host_strobe.py) and loaded
// with ctypes. A host library: no CUDA, no device code.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Keccak-f[1600]
// ---------------------------------------------------------------------------

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int RHO[5][5] = {{0, 36, 3, 41, 18},
                              {1, 44, 10, 45, 2},
                              {62, 6, 43, 15, 61},
                              {28, 55, 25, 21, 56},
                              {27, 20, 39, 8, 14}};

static inline uint64_t rotl64(uint64_t x, int n) {
  n &= 63;
  if (n == 0) return x;
  return (x << n) | (x >> (64 - n));
}

void keccak_f1600(uint8_t *state_bytes) {
  uint64_t A[5][5];
  for (int x = 0; x < 5; x++)
    for (int y = 0; y < 5; y++)
      std::memcpy(&A[x][y], state_bytes + 8 * (x + 5 * y), 8);

  for (int round = 0; round < 24; round++) {
    uint64_t C[5], D[5], B[5][5];
    for (int x = 0; x < 5; x++)
      C[x] = A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4];
    for (int x = 0; x < 5; x++)
      D[x] = C[(x + 4) % 5] ^ rotl64(C[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) A[x][y] ^= D[x];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        B[y][(2 * x + 3 * y) % 5] = rotl64(A[x][y], RHO[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        A[x][y] = B[x][y] ^ ((~B[(x + 1) % 5][y]) & B[(x + 2) % 5][y]);
    A[0][0] ^= RC[round];
  }

  for (int x = 0; x < 5; x++)
    for (int y = 0; y < 5; y++)
      std::memcpy(state_bytes + 8 * (x + 5 * y), &A[x][y], 8);
}

// ---------------------------------------------------------------------------
// STROBE-128 core ops (merlin subset), operating on a 208-byte context:
//   [0..200)  keccak state
//   [200]     pos
//   [201]     pos_begin
//   [202]     cur_flags
// ---------------------------------------------------------------------------

static const int STROBE_R = 166;
enum { FLAG_I = 1, FLAG_A = 2, FLAG_C = 4, FLAG_T = 8, FLAG_M = 16, FLAG_K = 32 };

struct StrobeCtx {
  uint8_t state[200];
  uint8_t pos;
  uint8_t pos_begin;
  uint8_t cur_flags;
};

static void run_f(StrobeCtx *ctx) {
  ctx->state[ctx->pos] ^= ctx->pos_begin;
  ctx->state[ctx->pos + 1] ^= 0x04;
  ctx->state[STROBE_R + 1] ^= 0x80;
  keccak_f1600(ctx->state);
  ctx->pos = 0;
  ctx->pos_begin = 0;
}

static void absorb(StrobeCtx *ctx, const uint8_t *data, uint64_t n) {
  for (uint64_t i = 0; i < n; i++) {
    ctx->state[ctx->pos] ^= data[i];
    if (++ctx->pos == STROBE_R) run_f(ctx);
  }
}

static void overwrite(StrobeCtx *ctx, const uint8_t *data, uint64_t n) {
  for (uint64_t i = 0; i < n; i++) {
    ctx->state[ctx->pos] = data[i];
    if (++ctx->pos == STROBE_R) run_f(ctx);
  }
}

static void squeeze(StrobeCtx *ctx, uint8_t *out, uint64_t n) {
  for (uint64_t i = 0; i < n; i++) {
    out[i] = ctx->state[ctx->pos];
    ctx->state[ctx->pos] = 0;
    if (++ctx->pos == STROBE_R) run_f(ctx);
  }
}

static void begin_op(StrobeCtx *ctx, uint8_t flags) {
  uint8_t old_begin = ctx->pos_begin;
  ctx->pos_begin = ctx->pos + 1;
  ctx->cur_flags = flags;
  uint8_t hdr[2] = {old_begin, flags};
  absorb(ctx, hdr, 2);
  if ((flags & (FLAG_C | FLAG_K)) && ctx->pos != 0) run_f(ctx);
}

void strobe_init(uint8_t *ctx_bytes, const uint8_t *label, uint64_t label_len) {
  StrobeCtx *ctx = reinterpret_cast<StrobeCtx *>(ctx_bytes);
  std::memset(ctx, 0, sizeof(StrobeCtx));
  static const uint8_t init[18] = {1,   STROBE_R + 2, 1,   0,   1,   96,
                                   'S', 'T', 'R', 'O', 'B', 'E',
                                   'v', '1', '.', '0', '.', '2'};
  std::memcpy(ctx->state, init, 18);
  keccak_f1600(ctx->state);
  begin_op(ctx, FLAG_M | FLAG_A);
  absorb(ctx, label, label_len);
}

void strobe_meta_ad(uint8_t *ctx_bytes, const uint8_t *data, uint64_t n,
                    int more) {
  StrobeCtx *ctx = reinterpret_cast<StrobeCtx *>(ctx_bytes);
  if (!more) begin_op(ctx, FLAG_M | FLAG_A);
  absorb(ctx, data, n);
}

void strobe_ad(uint8_t *ctx_bytes, const uint8_t *data, uint64_t n, int more) {
  StrobeCtx *ctx = reinterpret_cast<StrobeCtx *>(ctx_bytes);
  if (!more) begin_op(ctx, FLAG_A);
  absorb(ctx, data, n);
}

void strobe_prf(uint8_t *ctx_bytes, uint8_t *out, uint64_t n, int more) {
  StrobeCtx *ctx = reinterpret_cast<StrobeCtx *>(ctx_bytes);
  if (!more) begin_op(ctx, FLAG_I | FLAG_A | FLAG_C);
  squeeze(ctx, out, n);
}

void strobe_key(uint8_t *ctx_bytes, const uint8_t *data, uint64_t n, int more) {
  StrobeCtx *ctx = reinterpret_cast<StrobeCtx *>(ctx_bytes);
  if (!more) begin_op(ctx, FLAG_A | FLAG_C);
  overwrite(ctx, data, n);
}

// merlin Transcript::append_message applied to a batch of (label, message)
// pairs packed as [u32 label_len][label][u32 msg_len][msg]... — one ctypes
// crossing for a run of appends (allocate_point/allocate_account emit 2-5
// messages each).
void strobe_append_messages(uint8_t *ctx_bytes, const uint8_t *buf,
                            uint64_t count) {
  StrobeCtx *ctx = reinterpret_cast<StrobeCtx *>(ctx_bytes);
  const uint8_t *p = buf;
  for (uint64_t i = 0; i < count; i++) {
    uint32_t ll;
    std::memcpy(&ll, p, 4);
    p += 4;
    const uint8_t *label = p;
    p += ll;
    uint32_t ml;
    std::memcpy(&ml, p, 4);
    p += 4;
    begin_op(ctx, FLAG_M | FLAG_A);
    absorb(ctx, label, ll);
    uint8_t le[4] = {(uint8_t)(ml & 0xff), (uint8_t)((ml >> 8) & 0xff),
                     (uint8_t)((ml >> 16) & 0xff),
                     (uint8_t)((ml >> 24) & 0xff)};
    absorb(ctx, le, 4);
    begin_op(ctx, FLAG_A);
    absorb(ctx, p, ml);
    p += ml;
  }
}

// merlin TranscriptRngBuilder::rekey_with_witness_bytes applied to a batch
// of fixed-size witnesses in one call: per witness it runs
//   meta_ad(label, false); meta_ad(LE32(wlen), true); key(witness, false)
// exactly like the Python loop (prover.rs:66-81 semantics), saving ~3
// ctypes crossings per witness scalar.
void strobe_rekey_witnesses(uint8_t *ctx_bytes, const uint8_t *label,
                            uint64_t label_len, const uint8_t *witnesses,
                            uint64_t wlen, uint64_t count) {
  StrobeCtx *ctx = reinterpret_cast<StrobeCtx *>(ctx_bytes);
  uint8_t len_le[4] = {(uint8_t)(wlen & 0xff), (uint8_t)((wlen >> 8) & 0xff),
                       (uint8_t)((wlen >> 16) & 0xff),
                       (uint8_t)((wlen >> 24) & 0xff)};
  for (uint64_t i = 0; i < count; i++) {
    begin_op(ctx, FLAG_M | FLAG_A);
    absorb(ctx, label, label_len);
    absorb(ctx, len_le, 4);
    begin_op(ctx, FLAG_A | FLAG_C);
    overwrite(ctx, witnesses + i * wlen, wlen);
  }
}

}  // extern "C"
