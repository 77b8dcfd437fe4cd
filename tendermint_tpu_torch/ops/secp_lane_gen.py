"""Stage programs of the four-lane secp256k1 verify kernel (``tm_secp_verify``).

secp256k1 is, like BLS12-381's G1, a curve with a = 0 in Jacobian
coordinates, and the one-thread kernel adds and doubles with the formulas
the G1 programs of ``ops/bls_warp_gen.py`` are generated from
(add-2007-bl, dbl-2009-l). So the row's point operations are those graph
functions, ``prog_g1_hr``, ``prog_g1_add_fin`` and ``prog_g1_dbl``, compiled
by the same ``compile_program`` (at most 8 jobs a stage: two a lane on a
group of four lanes, and at most four products), over secp256k1's field
instead of BLS12-381's. The graphs only build products, sums and
differences of symbolic values, so the field is the interpreter's.

Two differences from the G1 programs:
- the sum of ``S_ADD_FIN`` and the double of ``S_DBL`` land in P's slots,
  in place, where the G1 programs write O; the kernel's accumulator stays
  in P. z3 is ((z1 + z2)^2 - z1z1 - z2z2) h where the one-thread
  ``pt_add`` computes 2 z1 z2 h: the same field element, and both cores
  keep every value canonical, so the limbs agree;
- consecutive addition stages merge into one (``merge_alu_stages``): a
  lane runs a chain of additions in order, jobs that touch a common slot
  on one lane, so no slot is written by one lane and touched by another
  inside a stage, and a run of dependent additions pays one stage's sync
  and shared-memory round trip instead of one each.

Slots (32 bytes, a field element as 8 x 32-bit limbs, plain form, not
Montgomery): 0 and 1 hold zero and one; P at 2-4, Q at 5-7 (a coordinate a
slot); ``S_HR``'s z1z1, z2z2, u1, s1, h, r at 8-13; temporaries from 14.

    python -m tendermint_tpu_torch.ops.secp_lane_gen   # rewrite the header

The tables go to ``ops/csrc/secp256k1_programs.cuh``; ``run_program`` in
``ops/csrc/secp256k1_device.cuh`` interprets them, on the card and in the
CPU harness ``tests/secp_lanes_host.cpp``. ``bls_warp_gen.simulate(prog,
slots, p=P)`` runs them in Python.
"""

from __future__ import annotations

import os
import pathlib

from . import bls_warp_gen as gen

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
HEADER = pathlib.Path(__file__).resolve().parent / "csrc" / "secp256k1_programs.cuh"

# the G1 programs' regions; temporaries start where G1's O was
S_P, S_Q = gen.G1_P, gen.G1_Q
S_Z1Z1, S_Z2Z2, S_U1, S_S1, S_H, S_R = (gen.G1_Z1Z1, gen.G1_Z2Z2, gen.G1_U1,
                                        gen.G1_S1, gen.G1_H, gen.G1_R)
S_TEMP = gen.G1_O
LANES = 4  # a row's group
JOBS_PER_STAGE = gen.G1_JOBS_PER_STAGE  # two a lane


def _into_p(build):
    """The graph `build` with its point output (O's three slots) written to
    P's slots instead."""
    def into_p(g):
        outs = build(g)
        assert [s for s, _ in outs] == [gen.G1_O + c for c in range(3)]
        return [(S_P + c, v) for c, (_, v) in enumerate(outs)]
    return into_p


# name -> graph function
PROGRAMS = {
    "S_HR": gen.prog_g1_hr,
    "S_ADD_FIN": _into_p(gen.prog_g1_add_fin),
    "S_DBL": _into_p(gen.prog_g1_dbl),
}


def _lane_chains(run: list, lanes: int) -> list:
    """The jobs of consecutive addition stages `run` as one stage, a list of
    jobs a lane: jobs that touch a common slot (one reads or writes what
    another wrote, or writes what another read) share a lane, in their
    stage order; the groups go largest first to the lane with the fewest
    jobs."""
    jobs = [w for js in run for w in js]
    parent = list(range(len(jobs)))

    def find(k):
        while parent[k] != k:
            parent[k] = parent[parent[k]]
            k = parent[k]
        return k

    writers, readers = {}, {}
    for k, w in enumerate(jobs):
        _, d, a, b = gen._decode(w)
        for other in [*(writers.get(s, []) for s in (a, b)), readers.get(d, []),
                      writers.get(d, [])]:
            for o in other:
                parent[find(o)] = find(k)
        for s in (a, b):
            readers.setdefault(s, []).append(k)
        writers.setdefault(d, []).append(k)
    groups = {}
    for k in range(len(jobs)):
        groups.setdefault(find(k), []).append(k)
    chains = [[] for _ in range(lanes)]
    for g in sorted(groups.values(), key=lambda g: (-len(g), g[0])):
        lane = min(range(lanes), key=lambda l: (len(chains[l]), l))
        chains[lane] += g
    return [[jobs[k] for k in sorted(c)] for c in chains]


def _depth(run: list, lanes: int) -> int:
    return max(len(c) for c in _lane_chains(run, lanes))


def merge_alu_stages(stages: list, lanes: int = LANES) -> list:
    """Runs of consecutive addition stages merged into one stage each, as
    long as the merged stage's longest lane chain is no longer than the
    runs' summed: a merge then saves a sync and a shared-memory round trip
    and lengthens no chain of additions (``_lane_chains`` keeps the stage
    rule: no slot is written by one lane and read or written by another).
    Lane l's jobs sit at l, l + lanes, l + 2 lanes, ... in order; a word 0
    is no job."""
    out, run = [], []

    def flush():
        if run:
            chains = _lane_chains(run, lanes)
            depth = max(len(c) for c in chains)
            words = [c[k] if k < len(c) else 0 for k in range(depth) for c in chains]
            while words[-1] == 0:
                words.pop()
            out.append(("alu", words))

    for kind, js in stages:
        if kind != "alu":
            flush()
            run = []
            out.append((kind, js))
        elif run and _depth(run + [js], lanes) > _depth(run, lanes) + _depth([js], lanes):
            flush()
            run = [js]
        else:
            run.append(js)
    flush()
    return out


def compile_all() -> dict[str, dict]:
    # every temporary its own slot, so that only true dependencies tie the
    # jobs of a merged addition stage to one lane
    progs = {name: gen.compile_program(name, build, S_TEMP, JOBS_PER_STAGE, reuse_slots=False)
             for name, build in PROGRAMS.items()}
    for p in progs.values():
        p["stages"] = merge_alu_stages(p["stages"])
        p["alu_stages"] = sum(1 for k, _ in p["stages"] if k == "alu")
        # run_program gives a product stage one product a lane
        assert all(len(js) <= LANES for kind, js in p["stages"] if kind == "mul"), p["name"]
        assert p["inv_stages"] == 0, p["name"]
    return progs


def render(progs: dict[str, dict]) -> str:
    stage_words, jobs, index = [], [], []
    for name, p in progs.items():
        first = len(stage_words)
        for kind, js in p["stages"]:
            stage_words.append(gen.KIND_CODE[kind] | len(js) << 2 | len(jobs) << 9)
            jobs.extend(js)
        index.append((name, first, len(stage_words) - first, p))
    lines = [
        "// Generated by tendermint_tpu_torch/ops/secp_lane_gen.py; do not edit.",
        "//",
        "// The stage programs of the four-lane secp256k1 verify kernel (run_program",
        "// in secp256k1_device.cuh), compiled from ops/bls_warp_gen.py's G1 graph",
        "// functions. A stage word is kind | jobs << 2 | first job << 9 (kind 0:",
        "// field multiplications, at most one a lane; 1: additions and",
        "// subtractions); a job is op | dst << 3 | a << 12 | b << 22 over",
        "// shared-memory slots of one field element (op 0 mul, 1 add, 2 sub; a",
        "// word 0 is no job). Lane l of a row's group of 4 runs jobs l, l + 4,",
        "// l + 8, ... of a stage, in order.",
        "// The tables are read at compile time: run_program unrolls a program.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "namespace sdev {",
        "namespace prog {",
        "",
        f"constexpr int ZERO_SLOT = {gen.ZERO_SLOT}, ONE_SLOT = {gen.ONE_SLOT};",
        "",
        "// regions (a coordinate a slot): the points P and Q, S_HR's values, and",
        "// the slots a row's programs use",
        f"constexpr int S_P = {S_P}, S_Q = {S_Q};",
        f"constexpr int S_Z1Z1 = {S_Z1Z1}, S_Z2Z2 = {S_Z2Z2}, S_U1 = {S_U1}, "
        f"S_S1 = {S_S1}, S_H = {S_H}, S_R = {S_R};",
        f"constexpr int S_SLOTS = {max(p['temps'] for p in progs.values())};",
        "",
        "// program: first stage, stages; its slots, field multiplications and",
        "// dependent multiplications along its longest path",
    ]
    for name, first, n, p in index:
        lines.append(
            f"constexpr int {name}_FIRST = {first}, {name}_N = {n};  "
            f"// {p['temps']} slots, {p['muls']} mul, path {p['path']}")
    lines += ["", f"constexpr uint32_t STAGES[{len(stage_words)}] = {{"]
    for i in range(0, len(stage_words), 8):
        lines.append("    " + " ".join(f"0x{x:08x}u," for x in stage_words[i:i + 8]))
    lines += ["};", "", f"constexpr uint32_t JOBS[{len(jobs)}] = {{"]
    for i in range(0, len(jobs), 8):
        lines.append("    " + " ".join(f"0x{x:08x}u," for x in jobs[i:i + 8]))
    lines += ["};", "", "}  // namespace prog", "}  // namespace sdev", ""]
    return "\n".join(lines)


def generate() -> str:
    return render(compile_all())


def main() -> None:
    progs = compile_all()
    for name, p in progs.items():
        print(f"{name}: {len(p['stages'])} stages ({p['mul_stages']} mul, "
              f"{p['alu_stages']} alu), {p['muls']} muls, path {p['path']}, "
              f"slots {p['temps']}")
    text = render(progs)
    tmp = HEADER.with_suffix(f".tmp{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, HEADER)
    print(f"wrote {HEADER} ({len(text)} bytes)")


if __name__ == "__main__":
    main()
