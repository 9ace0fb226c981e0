// Owen-scrambled Sobol' samples (samplers "sobol" / "sobol-b0"): the device
// form of tpu_ray_torch/core/qmc.py, which is the port's copy of
// tpu_ray/core/qmc.py.  The TPU kernels compute the camera sample inside the
// pool step (tpu_ray/ops/shade_pallas.py::_step_kernel) and the megakernel
// (tpu_ray/ops/megakernel.py::_kernel) as straight-line uint32 tile math;
// here it is the same uint32 math per thread: __brev is the bit reversal,
// the direction tables sit in constant memory (every thread of a warp
// reads the same word at the same step, which the constant cache
// broadcasts), multiplies wrap mod 2^32, and the 24-bit quantisation is one
// exact int-to-float conversion, so the draws equal the plain twin's bit for
// bit.  The sequence index is the plain global sample index; the camera salt
// goes into the scramble seeds only.  sobol_bounce0 is the first-bounce
// scatter draw of "sobol-b0", which the JAX package computes on its XLA
// work queue only; here the queue's step kernel draws it (pool_step.cu).
#pragma once

#include <stdint.h>

// Sobol' direction numbers of dims 2-5 (qmc.DEVICE_DIRS; dim 1 is the bit
// reversal of the index itself).  tests/test_torch_qmc.py holds these
// words equal to the ones core/qmc.py computes.
__constant__ uint32_t SOBOL_V[4][32] = {
    {0x80000000u, 0xC0000000u, 0xA0000000u, 0xF0000000u, 0x88000000u,
     0xCC000000u, 0xAA000000u, 0xFF000000u, 0x80800000u, 0xC0C00000u,
     0xA0A00000u, 0xF0F00000u, 0x88880000u, 0xCCCC0000u, 0xAAAA0000u,
     0xFFFF0000u, 0x80008000u, 0xC000C000u, 0xA000A000u, 0xF000F000u,
     0x88008800u, 0xCC00CC00u, 0xAA00AA00u, 0xFF00FF00u, 0x80808080u,
     0xC0C0C0C0u, 0xA0A0A0A0u, 0xF0F0F0F0u, 0x88888888u, 0xCCCCCCCCu,
     0xAAAAAAAAu, 0xFFFFFFFFu},
    {0x80000000u, 0xC0000000u, 0x60000000u, 0x90000000u, 0xE8000000u,
     0x5C000000u, 0x8E000000u, 0xC5000000u, 0x68800000u, 0x9CC00000u,
     0xEE600000u, 0x55900000u, 0x80680000u, 0xC09C0000u, 0x60EE0000u,
     0x90550000u, 0xE8808000u, 0x5CC0C000u, 0x8E606000u, 0xC5909000u,
     0x6868E800u, 0x9C9C5C00u, 0xEEEE8E00u, 0x5555C500u, 0x8000E880u,
     0xC0005CC0u, 0x60008E60u, 0x9000C590u, 0xE8006868u, 0x5C009C9Cu,
     0x8E00EEEEu, 0xC5005555u},
    {0x80000000u, 0xC0000000u, 0x20000000u, 0x50000000u, 0xF8000000u,
     0x74000000u, 0xA2000000u, 0x93000000u, 0xD8800000u, 0x25400000u,
     0x59E00000u, 0xE6D00000u, 0x78080000u, 0xB40C0000u, 0x82020000u,
     0xC3050000u, 0x208F8000u, 0x51474000u, 0xFBEA2000u, 0x75D93000u,
     0xA0858800u, 0x914E5400u, 0xDBE79E00u, 0x25DB6D00u, 0x58800080u,
     0xE54000C0u, 0x79E00020u, 0xB6D00050u, 0x800800F8u, 0xC00C0074u,
     0x200200A2u, 0x50050093u},
    {0x80000000u, 0x40000000u, 0x20000000u, 0xB0000000u, 0xF8000000u,
     0xDC000000u, 0x7A000000u, 0x9D000000u, 0x5A800000u, 0x2FC00000u,
     0xA1600000u, 0xF0B00000u, 0xDA880000u, 0x6FC40000u, 0x81620000u,
     0x40BB0000u, 0x22878000u, 0xB3C9C000u, 0xFB65A000u, 0xDDB2D000u,
     0x78022800u, 0x9C0B3C00u, 0x5A0FB600u, 0x2D0DDB00u, 0xA2878080u,
     0xF3C9C040u, 0xDB65A020u, 0x6DB2D0B0u, 0x800228F8u, 0x400B3CDCu,
     0x200FB67Au, 0xB00DDB9Du},
};

// Sobol' direction numbers of dims 6-10 (qmc.DEVICE_B0_DIRS): the first-bounce
// scatter draws of the sobol-b0 sampler on the work queue (dim 6, the
// mixture coin, stays hashed; its scramble seed still advances the chain).
// tests/test_torch_sobol_b0.py holds these words equal to core/qmc.py's.
__constant__ uint32_t SOBOL_B0_V[5][32] = {
    {0x80000000u, 0x40000000u, 0x60000000u, 0x30000000u, 0xC8000000u,
     0x24000000u, 0x56000000u, 0xFB000000u, 0xE0800000u, 0x70400000u,
     0xA8600000u, 0x14300000u, 0x9EC80000u, 0xDF240000u, 0xB6D60000u,
     0x8BBB0000u, 0x48008000u, 0x64004000u, 0x36006000u, 0xCB003000u,
     0x2880C800u, 0x54402400u, 0xFE605600u, 0xEF30FB00u, 0x7E48E080u,
     0xAF647040u, 0x1EB6A860u, 0x9F8B1430u, 0xD6C81EC8u, 0xBB249F24u,
     0x80D6D6D6u, 0x40BBBBBBu},
    {0x80000000u, 0xC0000000u, 0xA0000000u, 0xD0000000u, 0x58000000u,
     0x94000000u, 0x3E000000u, 0xE3000000u, 0xBE800000u, 0x23C00000u,
     0x1E200000u, 0xF3100000u, 0x46780000u, 0x67840000u, 0x78460000u,
     0x84670000u, 0xC6788000u, 0xA784C000u, 0xD846A000u, 0x5467D000u,
     0x9E78D800u, 0x33845400u, 0xE6469E00u, 0xB7673300u, 0x20F86680u,
     0x104477C0u, 0xF8668020u, 0x4477C010u, 0x668020F8u, 0x77C01044u,
     0x8020F866u, 0xC0104477u},
    {0x80000000u, 0x40000000u, 0xA0000000u, 0x50000000u, 0x88000000u,
     0x24000000u, 0x12000000u, 0x2D000000u, 0x76800000u, 0x9E400000u,
     0x08200000u, 0x64100000u, 0xB2280000u, 0x7D140000u, 0xFEA20000u,
     0xBA490000u, 0x1A248000u, 0x491B4000u, 0xC4B5A000u, 0xE3739000u,
     0xF6800800u, 0xDE400400u, 0xA8200A00u, 0x34100500u, 0x3A280880u,
     0x59140240u, 0xECA20120u, 0x974902D0u, 0x6CA48768u, 0xD75B49E4u,
     0xCC95A082u, 0x87639641u},
    {0x80000000u, 0x40000000u, 0xA0000000u, 0x50000000u, 0x28000000u,
     0xD4000000u, 0x6A000000u, 0x71000000u, 0x38800000u, 0x58400000u,
     0xEA200000u, 0x31100000u, 0x98A80000u, 0x08540000u, 0xC22A0000u,
     0xE5250000u, 0xF2B28000u, 0x79484000u, 0xFAA42000u, 0xBD731000u,
     0x18A80800u, 0x48540400u, 0x622A0A00u, 0xB5250500u, 0xDAB28280u,
     0xAD484D40u, 0x90A426A0u, 0xCC731710u, 0x20280B88u, 0x10140184u,
     0x880A04A2u, 0x84350611u},
    {0x80000000u, 0x40000000u, 0xE0000000u, 0xB0000000u, 0x98000000u,
     0x94000000u, 0x8A000000u, 0x5B000000u, 0x33800000u, 0xD9C00000u,
     0x72200000u, 0x3F100000u, 0xC1B80000u, 0xA6EC0000u, 0x53860000u,
     0x29F50000u, 0x0A3A8000u, 0x1B2AC000u, 0xD392E000u, 0x69FF7000u,
     0xEA380800u, 0xAB2C0400u, 0x4BA60E00u, 0xFDE50B00u, 0x60028980u,
     0xF006C940u, 0x7834E8A0u, 0x241A75B0u, 0x123A8B38u, 0xCF2AC99Cu,
     0xB992E922u, 0x82FF78F1u},
};

#define QMC_GOLD 0x9E3779B9u
#define QMC_MIX1 0x85EBCA6Bu
#define QMC_MIX2 0xC2B2AE35u

__device__ __forceinline__ uint32_t qmc_fmix(uint32_t x) {
  x ^= x >> 16;
  x *= QMC_MIX1;
  x ^= x >> 13;
  x *= QMC_MIX2;
  x ^= x >> 16;
  return x;
}

// Sobol' values of index i in dims 2-5, 0.32 fixed point: the XOR of the
// direction numbers chosen by the set bits of i.  The loop stops at i's
// highest set bit (the bits above it choose nothing), so a sample index
// below 2^n costs n steps, not 32; at each step every lane of a warp reads
// the same table word.
__device__ __forceinline__ void sobol_dims(uint32_t i, uint32_t r[4]) {
  r[0] = r[1] = r[2] = r[3] = 0u;
  const int n = 32 - __clz(i);
  for (int k = 0; k < n; ++k) {
    const uint32_t bit = (i >> k) & 1u;
    r[0] ^= bit * SOBOL_V[0][k];
    r[1] ^= bit * SOBOL_V[1][k];
    r[2] ^= bit * SOBOL_V[2][k];
    r[3] ^= bit * SOBOL_V[3][k];
  }
}

// hash-based Owen scramble (Laine-Karras on the bit-reversed value)
__device__ __forceinline__ uint32_t owen_scramble(uint32_t v, uint32_t seed) {
  uint32_t x = __brev(v);
  x ^= x * 0x3D20ADEAu;
  x += seed;
  x *= (seed >> 16) | 1u;
  x ^= x * 0x05526C56u;
  x ^= x * 0x53A22864u;
  return __brev(x);
}

__device__ __forceinline__ float qmc_unit(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// the five camera uniforms of (slot, plain global sample index gs): pixel
// jitter u0, u1 (dims 1-2), lens radius u2, lens angle u3, shutter time u4
// (dims 3-5) - qmc.pixel_uniforms and qmc.lens_time_uniforms
__device__ __forceinline__ void sobol_camera(uint32_t slot, uint32_t gs,
                                             uint32_t salt, float u[5]) {
  const uint32_t sx = qmc_fmix(slot + QMC_GOLD) ^ (salt * QMC_MIX1);
  const uint32_t sy = qmc_fmix(sx ^ QMC_MIX2);
  const uint32_t sr = qmc_fmix(sy + QMC_GOLD);
  const uint32_t sp = qmc_fmix(sr ^ QMC_MIX1);
  const uint32_t st = qmc_fmix(sp + QMC_MIX2);
  uint32_t v[4];
  sobol_dims(gs, v);
  u[0] = qmc_unit(owen_scramble(__brev(gs), sx));
  u[1] = qmc_unit(owen_scramble(v[0], sy));
  u[2] = qmc_unit(owen_scramble(v[1], sr));
  u[3] = qmc_unit(owen_scramble(v[2], sp));
  u[4] = qmc_unit(owen_scramble(v[3], st));
}

// Sobol' dims 7-10 of (pixel, plain global sample gs), Owen-scrambled: the
// first-bounce scatter draws of sampler "sobol-b0" on the work queue
// (qmc.bounce0_uniforms()[1:5]; the JAX XLA queue's override,
// tpu_ray/integrator.py:707-735): q[0], q[1] the light's (u, v) (scatter
// columns 2, 3), q[2], q[3] the cosine lobe's (columns 6, 7).  The seeds
// go on from the five camera dims' chain; dim 6's seed is drawn and unused.
__device__ __forceinline__ void sobol_bounce0(uint32_t pix, uint32_t gs,
                                              uint32_t salt, float q[4]) {
  uint32_t s = qmc_fmix(pix + QMC_GOLD) ^ (salt * QMC_MIX1);
  for (int k = 0; k < 4; ++k) s = qmc_fmix(s + QMC_GOLD);
  s = qmc_fmix(s ^ QMC_MIX2);            // dim 6 (the coin, not used)
  uint32_t seed[4];
  for (int k = 0; k < 4; ++k) {
    s = qmc_fmix(s ^ QMC_MIX2);
    seed[k] = s;
  }
  uint32_t r[4] = {0u, 0u, 0u, 0u};
  const int n = 32 - __clz(gs);
  for (int k = 0; k < n; ++k) {
    const uint32_t bit = (gs >> k) & 1u;
    r[0] ^= bit * SOBOL_B0_V[1][k];
    r[1] ^= bit * SOBOL_B0_V[2][k];
    r[2] ^= bit * SOBOL_B0_V[3][k];
    r[3] ^= bit * SOBOL_B0_V[4][k];
  }
  for (int k = 0; k < 4; ++k) q[k] = qmc_unit(owen_scramble(r[k], seed[k]));
}
