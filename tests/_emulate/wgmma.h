// Host emulation of the asynchronous pieces of flash_tc.cuh, inserted into
// a copy of it in place of the asm (see __init__.py). A copy lands at
// once; a wgmma reads its operands through the descriptor at once, with
// the 128-byte swizzle: logical address bits [4, 7) are XORed with bits
// [7, 10). K-major operand element (row r, depth k) sits at
// start + (r / 8) SBO + (r % 8) 128 + 2 k; MN-major (depth k, column n)
// at start + (n / 64) LBO + (k / 8) SBO + (k % 8) 128 + 2 (n % 64).
inline float emu_bf16_at(uint32_t logical) {
  const uint32_t at = logical ^ (((logical >> 7) & 7) << 4);
  __nv_bfloat16 b;
  std::memcpy(&b, emu_smem + at, 2);
  return __bfloat162float(b);
}
struct EmuDesc {
  uint32_t start, lbo, sbo;
};
inline EmuDesc emu_decode(uint64_t d) {
  if (((d >> 62) & 3) != 1) abort();  // only the 128-byte swizzle
  return {static_cast<uint32_t>(d & 0x3fff) << 4,
          static_cast<uint32_t>((d >> 16) & 0x3fff) << 4,
          static_cast<uint32_t>((d >> 32) & 0x3fff) << 4};
}
inline float emu_kmajor(uint64_t d, int r, int k) {
  const EmuDesc e = emu_decode(d);
  return emu_bf16_at(e.start + (r / 8) * e.sbo + (r % 8) * 128 + k * 2);
}
inline float emu_mnmajor(uint64_t d, int k, int n) {
  const EmuDesc e = emu_decode(d);
  return emu_bf16_at(e.start + (n / 64) * e.lbo + (k / 8) * e.sbo +
                     (k % 8) * 128 + (n % 64) * 2);
}
// Accumulator fragment: d[4 i + 2 h + e] is row 16 w + lane / 4 + 8 h,
// column 8 i + 2 (lane % 4) + e of the warpgroup's m64 tile.
template <int N>
inline void emu_wgmma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
  for (int i = 0; i < N / 8; ++i)
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * w + lane / 4 + 8 * h;
        const int col = 8 * i + 2 * (lane % 4) + e;
        float s = 0.f;
        for (int k = 0; k < 16; ++k)
          s += emu_kmajor(a, row, k) * emu_kmajor(b, col, k);
        float& x = d[4 * i + 2 * h + e];
        x = accumulate ? x + s : s;
      }
}
// A from registers: register r of a lane holds row lane / 4 + 8 (r % 2),
// columns 2 (lane % 4) + 8 (r / 2) and one more, low half first; a row's
// 16 values lie on the 4 lanes of its quad.
template <int N>
inline void emu_wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t b) {
  const int lane = threadIdx.x % 32;
  const Words mine{{a[0], a[1], a[2], a[3]}};
  Words quad[4];
  for (int q = 0; q < 4; ++q)
    quad[q] = emu_warp_exchange(mine, (lane / 4) * 4 + q);
  for (int i = 0; i < N / 8; ++i)
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * (lane % 4) + e;
        float s = 0.f;
        for (int k = 0; k < 16; ++k) {
          const uint32_t word = quad[(k % 8) / 2].w[2 * (k / 8) + h];
          const __nv_bfloat16 v{
              static_cast<uint16_t>(k % 2 ? word >> 16 : word & 0xffff)};
          s += __bfloat162float(v) * emu_mnmajor(b, k, col);
        }
        d[4 * i + 2 * h + e] += s;
      }
}
