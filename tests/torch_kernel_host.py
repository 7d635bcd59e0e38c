"""Build a kernel library of the port for the CPU and run its kernels.

``build_host_library(source, out_dir)`` converts a translation unit of
``windflow_tpu_torch/kernels`` (``forest_rebuild.cu``, or a traced
variant's ``Variant.text``) and the headers beside it for the host
stand-in of the CUDA runtime (``tests/torch_cuda_host.h``) and builds it
with g++ into a shared library that the wrappers' ctypes bindings take,
with CPU tensors' pointers. ``python3 tests/torch_kernel_host.py LIB``
runs the fieldwise library's K7 (``wf_keyed_fold``), K6
(``wf_tree_reduce``) and K2+K3 (``wf_ffat_ingest``) on the cases of
``CASES`` against their plain versions and prints one JSON object, case
name -> whether it matched (the tests run it in a child process with a
time limit, so that a kernel that never leaves a barrier fails a test
instead of hanging the run).
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
KERNELS = HERE.parent / "windflow_tpu_torch" / "kernels"
RUNTIME = HERE / "torch_cuda_host.h"


def host_source(text: str) -> str:
    """A kernel source as the host stand-in builds it."""
    text = re.sub(r"extern\s+__shared__\s+__align__\(\d+\)\s+(\w+)\s+"
                  r"(\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(wf_emul_dyn_smem);", text)
    text = re.sub(r'asm volatile\("ld\.acquire\.gpu\.global\.u32[^;]*;"'
                  r'\s*:\s*"=r"\(v\)\s*:\s*"l"\(p\)\s*:\s*"memory"\);',
                  "v = __atomic_load_n(p, __ATOMIC_ACQUIRE);", text,
                  flags=re.S)
    text = re.sub(r'asm volatile\("st\.release\.gpu\.global\.u32[^;]*;"'
                  r'\s*::\s*"l"\(p\),\s*"r"\(v\)\s*:\s*"memory"\);',
                  "__atomic_store_n(p, v, __ATOMIC_RELEASE);", text,
                  flags=re.S)
    text = re.sub(r"asm\s+volatile\((.*?)\);", ";", text, flags=re.S)
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\s*\((.*?)\);",
                  r"wf_emul_launch(\2, [&] { \1(\3); });", text, flags=re.S)


def build_host_library(source: str, out_dir: Path,
                       name: str = "kernels") -> Path:
    """g++ build of ``source`` (a translation unit's text) for the host
    stand-in, in ``out_dir``; returns the library's path."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in KERNELS.glob("*.cuh"):
        (out_dir / h.name).write_text(host_source(h.read_text()))
    shutil.copy(RUNTIME, out_dir / "cuda_runtime.h")
    main = out_dir / f"{name}.cpp"
    main.write_text(host_source(source))
    lib = out_dir / f"lib{name}.so"
    subprocess.run([gxx, "-std=c++20", "-O0", "-shared", "-fPIC", "-pthread",
                    "-D__CUDACC__", "-D__CUDA_ARCH__=900",
                    "-ffp-contract=off", f"-I{out_dir}", "-include",
                    str(out_dir / "cuda_runtime.h"), "-o", str(lib),
                    str(main)], check=True, capture_output=True, timeout=600)
    return lib


# (kernel, case): K7 (rows, slots, output rows, valid share or None, key
# layout or run lengths (a slot each, 0 for a slot with no run), and
# options: "br" block_rows, "ch" chunk_rows, "max_run" known (default)
# or None (the chunk blocks launched whatever the runs), "comb" the
# combine), K6 (rows, valid share or None, float plane, size or None,
# planes), K2+K3 (rows, K_cap, F, fields)
CASES = {
    "k7_small": ("k7", 300, 7, 8, None, "random", {}),
    "k7_valid": ("k7", 1000, 50, 64, 0.7, "random", {}),
    "k7_one_run": ("k7", 1000, 1, 1, None, "one", {}),
    "k7_every_row_a_slot": ("k7", 700, 700, 1024, None, "each", {}),
    "k7_sentinel_half": ("k7", 2000, 3, 5, 0.6, "sentinel",
                         {"max_run": None, "br": 128, "ch": 128}),
    "k7_all_sentinel": ("k7", 129, 4, 4, None, "all_sentinel",
                        {"max_run": None}),
    "k7_all_invalid": ("k7", 800, 20, 20, 0.0, "random", {}),
    "k7_many_slots": ("k7", 6000, 40, 300, 0.9, "random", {}),
    "k7_one_row": ("k7", 1, 1, 1, None, "one", {}),
    "k7_thread_warp_edges": ("k7", 0, 0, 16, None,
                             [31, 32, 33, 1, 31, 32, 33, 64, 2, 30], {}),
    "k7_thread_warp_edges_valid": ("k7", 0, 0, 12, 0.5,
                                   [33, 31, 2, 32, 1, 95, 31, 32], {}),
    "k7_warp_block_edges": ("k7", 0, 0, 8, 0.8,
                            [511, 512, 513, 5, 1023, 1024, 1025], {}),
    "k7_warp_block_edges_small": ("k7", 0, 0, 8, None,
                                  [127, 128, 129, 3, 255, 256, 257],
                                  {"br": 128, "ch": 128}),
    "k7_run_over_many_blocks": ("k7", 0, 0, 4, 0.7, [3, 6000, 2],
                                {"br": 128, "ch": 128}),
    "k7_keys_65536": ("k7", 65536, 65536, 65536, None, "each", {}),
    "k7_gaps_beside_long_runs": ("k7", 0, 0, 16, None,
                                 [0, 700, 0, 0, 600, 0, 3, 0, 0, 513, 0],
                                 {"br": 256, "ch": 128, "max_run": None}),
    "k7_gathered_and_selected": ("k7", 3000, 37, 64, 0.5, "random",
                                 {"comb": "v_sum"}),
    "k6_one_row": ("k6", 1, 1.0, False, None, 1),
    "k6_seven": ("k6", 7, 0.5, False, None, 1),
    "k6_two_levels": ("k6", 5000, 0.9, True, None, 2),
    "k6_ragged": ("k6", 70_001, 0.5, False, None, 1),
    "k6_all_invalid": ("k6", 3000, 0.0, True, None, 2),
    "k6_one_stage_edge": ("k6", 512, 0.5, False, None, 1),
    "k6_past_one_stage": ("k6", 513, 0.5, False, None, 1),
    "k6_two_stage_edge": ("k6", 65536, 0.5, False, None, 1),
    "k6_past_two_stages": ("k6", 65537, 0.5, True, None, 2),
    "k6_ten_words_edge": ("k6", 256, 0.5, True, None, 8),
    "k6_ten_words_three_stages": ("k6", 40_000, 0.5, True, None, 8),
    "k6_ragged_size": ("k6", 3000, None, True, 1234, 2),
    "k6_size_one": ("k6", 3000, None, False, 1, 1),
    "k23_one_field": ("k23", 3000, 16, 8, 1),
    "k23_three_fields": ("k23", 5000, 64, 4, 3),
    "k23_eight_fields": ("k23", 2000, 4, 2, 8),
    "k7_between_k23": ("between",),
}


def _columns(np, torch, rng, n):
    return {"key": torch.from_numpy(rng.integers(0, 99, n).astype(np.int32)),
            "v": torch.from_numpy(rng.integers(-50, 50, n).astype(np.int32)),
            "x": torch.from_numpy((1 + rng.random(n)).astype(np.float32)),
            "k64": torch.from_numpy(rng.integers(0, 1 << 40, n)),
            "pair": torch.from_numpy(rng.integers(0, 9, (n, 2)).astype(
                np.int32))}


def _k7_slots(np, rng, case):
    """(rows, slots, n_slots, sorted slots' order) of a K7 case."""
    _, n, n_slots, _, _, layout, _ = case
    if not isinstance(layout, str):  # run lengths, a slot each
        lens = np.asarray(layout)
        n, n_slots = int(lens.sum()), len(lens)
        slots = np.repeat(np.arange(n_slots), lens)[rng.permutation(n)]
        return n, slots, n_slots
    slots = {"one": np.zeros(n, np.int64), "each": np.arange(n) % n_slots,
             "all_sentinel": np.full(n, n_slots)}.get(
        layout, rng.integers(0, n_slots, n))
    if layout == "sentinel":
        slots = np.where(rng.random(n) < 0.5, n_slots, slots)
    if layout == "each":
        slots = slots[rng.permutation(n)]
    return n, slots, n_slots


def _k7(lib, case, seed):
    import numpy as np
    import torch
    from windflow_tpu_torch import fieldwise
    from windflow_tpu_torch.kernels import reduce_fold as rf
    out_rows, frac, opts = case[3], case[4], case[6]
    rng = np.random.default_rng(seed)
    n, slots, n_slots = _k7_slots(np, rng, case)
    order = np.argsort(slots, kind="stable")
    fields = _columns(np, torch, rng, n)
    valid = None if frac is None else torch.from_numpy(rng.random(n) < frac)
    comb = (fieldwise(v="sum") if opts.get("comb") == "v_sum"
            else fieldwise(v="sum", x="max"))
    o = torch.from_numpy(order.astype(np.int32))
    sk = torch.from_numpy(slots[order].astype(np.int32))
    starts = rf.run_starts(sk, n_slots)
    lens = np.diff(starts.numpy())
    max_run = opts.get("max_run", int(lens.max(initial=0)))
    br, ch = opts.get("br", rf.BLOCK_ROWS), opts.get("ch", rf.CHUNK_ROWS)
    call = rf.make_call(comb, fields, lib)
    ref, rv = rf.keyed_fold_ref(comb, fields, o, sk, n_slots, valid, out_rows)
    got, gv = rf.launch_keyed_fold(
        call, fields, o, sk, starts, n_slots, valid, out_rows,
        rf.chunk_blocks(n, max_run, br, ch), 0, br, ch)
    ok = torch.equal(gv, rv)
    for f in fields:
        ok &= torch.equal(got[f][rv], ref[f][rv])
        if f in call.planes + call.gathered and frac is None:
            ok &= not got[f][~rv].any()  # no run: zeros
    return bool(ok)


def _k6(lib, case, seed):
    import numpy as np
    import torch
    from windflow_tpu_torch import fieldwise
    from windflow_tpu_torch.kernels import reduce_fold as rf
    _, n, frac, floats, size, planes = case
    rng = np.random.default_rng(seed)
    fields = _columns(np, torch, rng, n)
    for i in range(2, planes):
        fields[f"w{i}"] = torch.from_numpy(rng.integers(-9, 9, n).astype(
            np.int32))
    valid = None if frac is None else torch.from_numpy(rng.random(n) < frac)
    ops = {"v": "min", **({"x": "sum"} if floats else {}),
           **{f"w{i}": ("sum", "max")[i % 2] for i in range(2, planes)}}
    comb = fieldwise(**ops)
    call = rf.make_call(comb, fields, lib)
    mask = valid if size is None else torch.arange(n) < size
    ref, rv = rf.tree_reduce_ref(comb, fields, mask)
    got, gv = rf.launch_tree_reduce(call, fields, valid,
                                    n if size is None else size, 0)
    ok = torch.equal(gv, rv)
    for f in fields:
        if f in call.planes or rv.all():
            a, b = got[f], ref[f]
            if a.dtype is torch.float32:  # bit for bit
                a, b = a.view(torch.int32), b.view(torch.int32)
            ok &= torch.equal(a, b)
    return bool(ok)


def _k23_inputs(np, torch, rng, n, K, F, nf):
    from windflow_tpu_torch import fieldwise
    from windflow_tpu_torch.kernels import ffat_step as fs
    comb = fieldwise(**{f"f{i}": ("sum", "min", "max")[i % 3]
                        for i in range(nf)})
    comp = torch.from_numpy(rng.integers(0, K * F + 1, n).astype(np.int32))
    vals = {f"f{i}": torch.from_numpy(rng.integers(-9, 9, n).astype(
        np.int32)) for i in range(nf)}
    flat = {f"f{i}": torch.from_numpy(rng.integers(-9, 9, K * 2 * F).astype(
        np.int32)) for i in range(nf)}
    vflat = torch.from_numpy(rng.random(K * 2 * F) < 0.5)
    return comb, comp, fs.sort_rows(comp), vals, flat, vflat


def _k23_launch(lib, comb, srt, vals, flat, vflat, F):
    import torch
    from windflow_tpu_torch.kernels import ffat_step as fs
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    order, sk = srt
    n = order.numel()
    status, rows, seq = fs.ingest_scratch(torch.device("cpu"), 0, n,
                                          len(flat))
    fs._bind(lib)
    return lib.wf_ffat_ingest(
        fs._ptrs(flat.values()), fs._ptrs(vals[k] for k in flat),
        fs._kinds(fr.Variant(fr.FIELDWISE), comb, flat), len(flat),
        vflat.data_ptr(), sk.data_ptr(), sk.element_size(),
        order.data_ptr(), n, F, vflat.numel() // 2, status.data_ptr(),
        status.numel(), rows.data_ptr(), rows.numel(), seq, None)


def _k23(lib, case, seed):
    import numpy as np
    import torch
    from windflow_tpu_torch.kernels import ffat_step as fs
    _, n, K, F, nf = case
    rng = np.random.default_rng(seed)
    comb, comp, srt, vals, flat, vflat = _k23_inputs(np, torch, rng, n, K, F,
                                                     nf)
    rf_, rv = {k: t.clone() for k, t in flat.items()}, vflat.clone()
    fs.ingest_fold_ref(comb, vals, comp, srt[0], rf_, rv, F)
    err = _k23_launch(lib, comb, srt, vals, flat, vflat, F)
    return err == 0 and torch.equal(vflat, rv) and all(
        torch.equal(flat[k], rf_[k]) for k in flat)


def _between(lib, seed):
    """K2+K3, K7 and K2+K3 on one stream's scratch, each exact."""
    import numpy as np
    import torch
    from windflow_tpu_torch.kernels import ffat_step as fs
    rng = np.random.default_rng(seed)
    ingests = [_k23_inputs(np, torch, rng, n, 32, 4, 2) for n in (3000, 900)]
    refs = []
    for comb, comp, srt, vals, flat, vflat in ingests:
        rf_, rv = {k: t.clone() for k, t in flat.items()}, vflat.clone()
        fs.ingest_fold_ref(comb, vals, comp, srt[0], rf_, rv, 4)
        refs.append((rf_, rv))
    comb, _, srt, vals, flat, vflat = ingests[0]
    ok = _k23_launch(lib, comb, srt, vals, flat, vflat, 4) == 0
    ok &= _k7(lib, CASES["k7_many_slots"], seed)
    comb, _, srt, vals, flat, vflat = ingests[1]
    ok &= _k23_launch(lib, comb, srt, vals, flat, vflat, 4) == 0
    for (_, _, _, _, flat, vflat), (rf_, rv) in zip(ingests, refs):
        ok &= torch.equal(vflat, rv) and all(torch.equal(flat[k], rf_[k])
                                             for k in flat)
    return bool(ok)


def run_cases(lib_path: str) -> dict:
    lib = ctypes.CDLL(lib_path)
    out = {}
    for i, (name, case) in enumerate(CASES.items()):
        run = {"k7": _k7, "k6": _k6, "k23": _k23}.get(case[0])
        out[name] = (_between(lib, i) if run is None
                     else run(lib, case, i))
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    print(json.dumps(run_cases(sys.argv[1])))
