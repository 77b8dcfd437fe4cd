// Generated by tendermint_tpu_torch/ops/secp_lane_gen.py; do not edit.
//
// The stage programs of the four-lane secp256k1 verify kernel (run_program
// in secp256k1_device.cuh), compiled from ops/bls_warp_gen.py's G1 graph
// functions. A stage word is kind | jobs << 2 | first job << 9 (kind 0:
// field multiplications, at most one a lane; 1: additions and
// subtractions); a job is op | dst << 3 | a << 12 | b << 22 over
// shared-memory slots of one field element (op 0 mul, 1 add, 2 sub; a
// word 0 is no job). Lane l of a row's group of 4 runs jobs l, l + 4,
// l + 8, ... of a stage, in order.
// The tables are read at compile time: run_program unrolls a program.
#pragma once

#include <stdint.h>

namespace sdev {
namespace prog {

constexpr int ZERO_SLOT = 0, ONE_SLOT = 1;

// regions (a coordinate a slot): the points P and Q, S_HR's values, and
// the slots a row's programs use
constexpr int S_P = 2, S_Q = 5;
constexpr int S_Z1Z1 = 8, S_Z2Z2 = 9, S_U1 = 10, S_S1 = 11, S_H = 12, S_R = 13;
constexpr int S_SLOTS = 32;

// program: first stage, stages; its slots, field multiplications and
// dependent multiplications along its longest path
constexpr int S_HR_FIRST = 0, S_HR_N = 3;  // 18 slots, 8 mul, path 2
constexpr int S_ADD_FIN_FIRST = 3, S_ADD_FIN_N = 7;  // 30 slots, 8 mul, path 3
constexpr int S_DBL_FIRST = 10, S_DBL_N = 6;  // 32 slots, 7 mul, path 3

constexpr uint32_t STAGES[16] = {
    0x00000010u, 0x00000810u, 0x00001009u, 0x0000140du, 0x00001a0cu, 0x00002015u, 0x00002a0cu, 0x00003035u,
    0x00004a08u, 0x00004e15u, 0x0000580cu, 0x00005e15u, 0x0000680cu, 0x00006e55u, 0x00009804u, 0x00009a05u,
};

constexpr uint32_t JOBS[78] = {
    0x01004040u, 0x01c07048u, 0x01c03070u, 0x01804078u, 0x02402050u, 0x02005080u, 0x03809058u, 0x03c08088u,
    0x02810062u, 0x02c1106au, 0x0300c071u, 0x0340d079u, 0x01c04081u, 0x0380e088u, 0x03c0f090u, 0x04010098u,
    0x020130a2u, 0x00000000u, 0x00000000u, 0x00000000u, 0x024140aau, 0x0440c0b0u, 0x0440a0b8u, 0x0540c020u,
    0x058120c2u, 0x00000000u, 0x00000000u, 0x00000000u, 0x05c180cau, 0x00000000u, 0x00000000u, 0x00000000u,
    0x05c19012u, 0x00000000u, 0x00000000u, 0x00000000u, 0x008170d2u, 0x0580b0d8u, 0x0680f0e0u, 0x06c1b0e9u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x0741c01au, 0x00c03070u, 0x00802078u, 0x01003080u, 0x03c0f091u,
    0x03802089u, 0x04010021u, 0x00000000u, 0x0480f099u, 0x044110a0u, 0x0380e0a8u, 0x04c130b0u, 0x03c140bau,
    0x054150c1u, 0x00000000u, 0x00000000u, 0x054170cau, 0x060180d1u, 0x00000000u, 0x00000000u, 0x064190d9u,
    0x0681a0e1u, 0x00000000u, 0x00000000u, 0x06c160eau, 0x00000000u, 0x00000000u, 0x00000000u, 0x06c1d012u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x0081b0f2u, 0x078130f8u, 0x0701f01au,
};

}  // namespace prog
}  // namespace sdev
