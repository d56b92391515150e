// bf16 on the host: round to nearest even, as the card converts.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;  // x is the low half
};
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = static_cast<uint32_t>(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000)  // NaN stays NaN
    return {static_cast<uint16_t>((u >> 16) | 0x40)};
  u += 0x7fff + ((u >> 16) & 1);
  return {static_cast<uint16_t>(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
