"""Forms of the long-KV kernels' 704-wide instantiations (`<11>`: K1 in
``csrc/flash_attention_fwd_longkv_sm90.cu``, K2 and K3 in
``csrc/flash_attention_bwd_longkv_sm90.cu``), and of K1 at the flow
encoder and decoder, side by side on one card.

On a machine with an NVIDIA GPU, from the repository root:

    python -m perceiverio_pytorch_tpu_torch.tools.longkv_forms [k1 | bwd | flow | FORM ...]

``flow`` times K1's forms at the flow sites (``FLOW_FORMS``) from the
sources as they are, each launched through its C entry point with its own
plan: at the decoder (182,528 queries over 2,048 latents, 512 wide) (a) the
long-KV `<8>` with one split, a block a query tile; (b) the long-Q kernel of
``csrc/flash_attention_fwd_longq_sm90.cu``, persistent blocks; at the
encoder (2,048 latents over 182,528 pixels, 322 wide, q, k and v first
copied into 16-byte rows) (a) the long-KV `<6>` with the one-wave split
plan (``_longkv_dq_split_plan``); (b) with ``_longkv_fwd_split_plan``'s;
each at batch 1 and 6 and held against the plain version on masked cases
first (ragged last tiles, d != dv, all masks, an all-masked entry).  It
prints the long-Q and `<6>`/`<8>` kernels' registers, spills and stack
(``nvcc -Xptxas -v``) and the long-Q kernel's shared memory and ring slots.

A form is a source with a few lines changed (``FORMS``; "kept" and
"k1_kept" are the sources as they are).  Each runs in a process of its
own: the package's ``csrc/`` is copied into ``build/forms/<form>/``,
edited, compiled with ``nvcc -Xptxas -v`` (the `<11>` kernels' registers,
spills and stack are printed, with their shared memory and ring slots as
the source computes them), built into that directory's own kernel
libraries and held against the plain version on a masked 704-wide case
over 4,301 keys.  A backward form: relative max error of dQ, dK, dV,
exact zeros on wiped rows and tail keys, two calls bit for bit; then K2
and K3 are timed apart at the multimodal encoder (784 latents over 52,097
keys, bf16).  A K1 form: relative max error of the output, the lse's
largest difference and its +inf rows, exact zeros on wiped rows, two calls
bit for bit; then K1 (with its merge) is timed there.  Each time is read
twice, each the mean over at least 5 launches and 30 ms.  ``bwd`` runs
every backward form and then "kept" again, ``k1`` every K1 form and then
"k1_kept" again, so that the first and last readings bound the card's
drift; with no argument, both.  It checks and prints; ``chip_smoke.py``
and the card tests are the checks that fail.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

SOURCES = {"K1": "flash_attention_fwd_longkv_sm90.cu",
           "K2/K3": "flash_attention_bwd_longkv_sm90.cu"}
MULTIMODAL_SITE = (1, 784, 52097, 1, 704, 704)
MASKED_CASE = (2, 129, 4301, 1, 704, 704)
_K2_LAG = "constexpr int LAG = L::SHORT_O ? L::NSO - 2 : NM;"
_K3_NSV = "static constexpr int NSV = SHORT_V ? (FIT - NM + 2) / 2 : FIT / 2;"
_K2_DP_RELEASE = """          if (step_release) {
            sm90::wgmma_commit();
            if (c > 0) {
              sm90::wgmma_wait<1>();
              if (lane == 0) sm90::mbar_arrive(&empty_first[prev]);
            }
          }"""
_K2_DP_LAST = """          if (step_release)
            sm90::mbar_arrive(&empty_first[prev]);
          else
"""
_K1_SLOTS = "constexpr int WIDE_K_SLOTS = 6;"
_K1_COLS = "constexpr int WIDE_V_COLS = 64;"
_K1_LAG = "constexpr int WIDE_V_LAG = 1;"
_K1_KEYS = "constexpr int WIDE_STEP_KEYS = 64;"


def _k1(slots=6, cols=64, lag=1, keys=64):
    """The K1 form's edits of the WIDE_* constants."""
    return [(line, line.replace(old, str(new))) for line, old, new in (
        (_K1_SLOTS, "6", slots), (_K1_COLS, "64", cols), (_K1_LAG, "1", lag),
        (_K1_KEYS, "64", keys)) if str(new) != old]


# name: (what differs from the source, [(line as it is, line in the form)]);
# the K1 forms' names start with "k1_".
FORMS = {
    "kept": ("K2: dO ring 4 slots, dV^T/dK^T chunks released 2 commit groups behind;"
             " K3: K ring 15 slots, V ring 6", []),
    "k2_lag3": ("K2: chunks released 3 groups behind (as many as the dO ring allows)",
                [(_K2_LAG, _K2_LAG.replace("NSO - 2", "NSO - 1"))]),
    "k2_lag1": ("K2: chunks released 1 group behind",
                [(_K2_LAG, _K2_LAG.replace("NSO - 2", "NSO - 3"))]),
    "k2_dp_wait0": ("K2: dP releases each dO chunk as soon as its own group is done",
                    [(_K2_DP_RELEASE, """          if (step_release) {
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            if (lane == 0) sm90::mbar_arrive(&empty_first[fs]);
          }"""), (_K2_DP_LAST, "          if (!step_release)\n")]),
    "k2_q12_o3": ("K2: Q ring 12 slots, dO ring 3, chunks released 2 groups behind",
                  [("static constexpr int NSQ = SHORT_O ? NM : FIT",
                    "static constexpr int NSQ = SHORT_O ? NM + 1 : FIT"),
                   (_K2_LAG, _K2_LAG.replace("NSO - 2", "NSO - 1"))]),
    "k3_13_8": ("K3: K ring 13 slots, V ring 8",
                [(_K3_NSV, _K3_NSV.replace("(FIT - NM + 2) / 2", "8"))]),
    "k3_17_4": ("K3: K ring 17 slots, V ring 4",
                [(_K3_NSV, _K3_NSV.replace("(FIT - NM + 2) / 2", "4"))]),
    "k1_kept": ("K1: steps of 64 keys, V in chunks of 64 columns (6 / 5 O tiles),"
                " K ring 6 slots, V ring 10, each chunk released 1 group behind", []),
    "k1_lag2": ("K1: V chunks released 2 groups behind", _k1(lag=2)),
    "k1_k4": ("K1: K ring 4 slots, V ring 12, 2 behind", _k1(slots=4, lag=2)),
    "k1_k8": ("K1: K ring 8 slots, V ring 8", _k1(slots=8)),
    "k1_v32": ("K1: V in chunks of 32 columns (64-byte swizzle, 11 O tiles a warpgroup),"
               " K ring 11 slots (a step, released after S), V ring 10", _k1(slots=11, cols=32)),
    "k1_v32_lag2": ("K1: as k1_v32, V chunks released 2 groups behind",
                    _k1(slots=11, cols=32, lag=2)),
    "k1_v32_k8": ("K1: as k1_v32, K ring 8 (released one by one), V ring 16, 2 behind",
                  _k1(slots=8, cols=32, lag=2)),
    "k1_v32_k5": ("K1: as k1_v32, K ring 5, V ring 22, 3 behind", _k1(slots=5, cols=32, lag=3)),
    "k1_keys32": ("K1: steps of 32 keys (S as N = 16 products), V in chunks of 32 columns,"
                  " K ring 11 slots (a step), V ring 42 of 2 KB, 2 behind",
                  _k1(slots=11, cols=32, lag=2, keys=32)),
}
_KEPT = {"K1": "k1_kept", "K2/K3": "kept"}


def _kernel(name: str) -> str:
    """The kernel a form changes: "K1" or "K2/K3"."""
    return "K1" if name.startswith("k1_") else "K2/K3"


def _prepare(name: str, fa) -> str:
    """csrc/ copied into build/forms/<name>/ and edited; the form's
    directory.  ``fa`` then builds and loads from there."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(fa._CSRC)))
    root = os.path.join(repo, "build", "forms", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(fa._CSRC, os.path.join(root, "csrc"))
    path = os.path.join(root, "csrc", SOURCES[_kernel(name)])
    with open(path) as f:
        text = f.read()
    for old, new in FORMS[name][1]:
        if text.count(old) != 1:
            raise SystemExit(f"form {name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    fa._CSRC = os.path.join(root, "csrc")
    fa.set_build_dir(os.path.join(root, "kernels"))
    return root


def _ptxas(name: str, root: str, fa) -> None:
    proc = subprocess.run(
        [fa._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", os.path.join(root, "ptxas.so"),
         os.path.join(root, "csrc", SOURCES[_kernel(name)])], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"form {name}: nvcc exit {proc.returncode}\n{proc.stderr[-4000:]}")
    kernel = None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = entry.group(1)
        elif kernel and "ILi11E" in kernel and ("Used" in line or "spill" in line):
            short = "K2 <11>" if "dkv" in kernel else "K3 <11>" if "dq" in kernel else "K1 <11>"
            print(f"[forms] {name} ptxas {short}: {line.split('info    :')[-1].strip()}",
                  flush=True)


def _smem(name: str, paths) -> None:
    if _kernel(name) == "K1":
        lib = ctypes.CDLL(paths["fwd_longkv"])
        fn = lib.flash_attention_fwd_longkv_smem
        fn.argtypes = (ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int))
        a, b = ctypes.c_int(0), ctypes.c_int(0)
        smem = fn(704, ctypes.byref(a), ctypes.byref(b))
        print(f"[forms] {name} smem: K1 K ring {a.value}, V ring {b.value}, {smem} B", flush=True)
        return
    lib = ctypes.CDLL(paths["bwd_longkv"])
    for fn in (lib.flash_attention_bwd_longkv_smem, lib.flash_attention_bwd_dq_longkv_smem):
        fn.argtypes = (ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int))
    a, b = ctypes.c_int(0), ctypes.c_int(0)
    smem = lib.flash_attention_bwd_longkv_smem(704, ctypes.byref(a), ctypes.byref(b))
    line = f"K2 Q ring {a.value}, dO ring {b.value}, {smem} B"
    smem = lib.flash_attention_bwd_dq_longkv_smem(704, ctypes.byref(a), ctypes.byref(b))
    print(f"[forms] {name} smem: {line}; K3 K ring {a.value}, V ring {b.value}, {smem} B",
          flush=True)


def _backward_args(shape, masked, gen):
    """(q, k, v, out, lse, grad) and the masks of a bf16 case
    (``kernel_report._case``)."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
    from perceiverio_pytorch_tpu_torch.tools.kernel_report import _case

    (q, k, v), kw = _case(*shape, torch.bfloat16, masked, False, gen)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    grad = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    return (q, k, v, out, lse, grad), kw


def _run_k1(name: str, gen) -> None:
    """K1 of a form: the masked case against the plain version, then K1
    timed at the multimodal encoder."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
    from perceiverio_pytorch_tpu_torch.tools.kernel_report import _case, _window_ms

    (q, k, v), kw = _case(*MASKED_CASE, torch.bfloat16, True, False, gen)
    if fa.launch_plan(q, k, v, kv_logical_len=kw["kv_logical_len"])["route"] != "sm90_longkv":
        raise SystemExit(f"form {name}: the masked case is off the long-KV route")
    got, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    again, again_lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    want, want_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                                  return_lse=True, **kw)
    torch.cuda.synchronize()
    rel = ((got.float() - want).abs().max() / want.abs().max()).item()
    finite = torch.isfinite(want_lse)
    lse_err = (lse[finite] - want_lse[finite]).abs().max().item()
    inf_rows = torch.equal(finite, torch.isfinite(lse))
    wiped = ~kw["q_mask"]
    wiped[-1] = True
    zeros = got.view(*wiped.shape, -1)[wiped].abs().max().item() == 0
    bitwise = torch.equal(got, again) and torch.equal(lse, again_lse)
    (q, k, v), _ = _case(*MULTIMODAL_SITE, torch.bfloat16, False, False, gen)
    plan = fa.launch_plan(q, k, v)
    if plan["route"] != "sm90_longkv":
        raise SystemExit(f"form {name}: the multimodal encoder's plan is {plan}")
    k1 = [_window_ms(lambda: fa.flash_attention(q, k, v), 5, 30.0)[0] for _ in range(2)]
    print(f"[forms] {name} ({FORMS[name][0]}): {MASKED_CASE} rel out {rel:.3g}, lse"
          f" {lse_err:.3g}, +inf rows alike {inf_rows}, exact zeros {zeros}, bit for bit"
          f" {bitwise}; at {MULTIMODAL_SITE}: K1 {k1[0]:.4f}/{k1[1]:.4f} ms", flush=True)


def run_form(name: str) -> None:
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
    from perceiverio_pytorch_tpu_torch.tools.kernel_report import _window_ms

    root = _prepare(name, fa)
    _ptxas(name, root, fa)
    paths = fa.build()
    _smem(name, paths)
    gen = torch.Generator(device="cuda").manual_seed(5)
    if _kernel(name) == "K1":
        _run_k1(name, gen)
        return
    args, kw = _backward_args(MASKED_CASE, True, gen)
    got = fa.flash_attention_backward(*args, **kw)
    again = fa.flash_attention_backward(*args, **kw)
    want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
    torch.cuda.synchronize()
    rel = [((x.float() - y).abs().max() / y.abs().max()).item() for x, y in zip(got, want)]
    wiped_rows = ~kw["q_mask"]
    wiped_rows[-1] = True
    tail = kw["kv_logical_len"]
    zeros = all(x.abs().max().item() == 0 for x in (
        got[0][wiped_rows], got[1][:, tail:], got[2][:, tail:], got[1][-1], got[2][-1]))
    bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
    args, _ = _backward_args(MULTIMODAL_SITE, False, gen)
    kernels = fa.BackwardKernels(*args, q_mask=None, kv_mask=None, softmax_scale=None,
                                 kv_logical_len=None)
    if kernels.plan["route"] != "sm90_longkv":
        raise SystemExit(f"form {name}: the multimodal encoder's plan is {kernels.plan}")
    k2 = [_window_ms(kernels.dkv, 5, 30.0)[0] for _ in range(2)]
    k3 = [_window_ms(kernels.dq, 5, 30.0)[0] for _ in range(2)]
    print(f"[forms] {name} ({FORMS[name][0]}): {MASKED_CASE} rel dq/dk/dv "
          f"{', '.join(f'{x:.3g}' for x in rel)}, exact zeros {zeros}, bit for bit {bitwise};"
          f" at {MULTIMODAL_SITE}: K2 {k2[0]:.4f}/{k2[1]:.4f} ms, K3 {k3[0]:.4f}/{k3[1]:.4f} ms",
          flush=True)


# The flow sites (B, Tq, Tk, H, D, Dv) and masked cases of their shapes
# (ragged last query tiles, d != dv), K1 forms named by site and letter.
FLOW_DECODER = (1, 182528, 2048, 1, 512, 512)
FLOW_ENCODER = (1, 2048, 182528, 1, 322, 322)
FLOW_MASKED = ((2, 8500, 777, 1, 512, 512), (2, 8600, 2100, 2, 300, 264),
               (2, 200, 4400, 1, 322, 322), (2, 9000, 130, 1, 264, 512))
FLOW_FORMS = {
    "decoder_a": "the long-KV <8>, one split, a block a query tile",
    "decoder_b": "long-Q, persistent blocks",
    "encoder_a": "the long-KV <6>, the one-wave split plan",
    "encoder_b": "the long-KV <6>, the whole-wave split plan",
}


def _flow_plan(form, q, k, v, kv_len):
    """The launch plan of K1 ``form`` on these tensors."""
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    b, tq, h, _ = q.shape
    copies = fa._k1_copies(q, k, v)
    if form == "decoder_b":
        return dict(route="sm90_longq", splits=1, copies=copies,
                    blocks=min(-(-tq // fa.BLOCK_Q) * h * b, fa.NUM_SMS))
    if form == "decoder_a":
        splits, per = 1, -(-kv_len // fa.BLOCK_K)
    elif form == "encoder_a":
        splits, per = fa._longkv_dq_split_plan(b, tq, h, kv_len)
    else:
        splits, per = fa._longkv_fwd_split_plan(b, tq, h, kv_len, max(q.shape[3], v.shape[3]))
    return dict(route="sm90_longkv", splits=splits, tiles_per_split=per, copies=copies)


def _flow_call(plan, q, k, v, kw):
    """K1 on ``plan``'s route, its merge after a split: (out, lse), as
    ``_flash_attention_cuda`` makes them."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    scale, kv_len = fa._scale_and_len(q, k, None, kw.get("kv_logical_len"))
    kv_mask = kw.get("kv_mask")
    q_mask = kw.get("q_mask")
    kv_mask = None if kv_mask is None else kv_mask.to(torch.bool).contiguous()
    q_mask = None if q_mask is None else q_mask.to(torch.bool).contiguous()
    out = torch.empty((b, tq, h * dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    splits = plan["splits"]
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((splits, b, h, tq, dv), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((2, splits, b, h, tq), dtype=torch.float32, device=q.device)
    libs = fa._load()
    stream = torch.cuda.current_stream().cuda_stream
    if plan["route"] == "sm90_longq":
        err, args = fa._aligned_rows(libs["fwd_longkv"], plan["copies"], q, k, v, stream)
        if err == 0:
            err = libs["fwd_longq"].flash_attention_fwd_longq_sm90(
                *(t.data_ptr() for t in args), fa._ptr(kv_mask), fa._ptr(q_mask),
                out.data_ptr(), lse.data_ptr(), b, h, tq, tk, kv_len, d, dv,
                *(x for t in args for x in t.stride()[:3]), scale, stream)
    else:
        err = fa._longkv_forward(libs["fwd_longkv"], plan, q, k, v, kv_mask, q_mask, out, lse,
                                 part_o, part_ml, kv_len, scale, stream)
    if err == 0 and splits > 1:
        err = libs["fwd"].flash_attention_fwd_merge(
            part_o.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(), fa._ptr(q_mask),
            out.data_ptr(), lse.data_ptr(), 1, splits, b, h, tq, dv, stream)
    if err != 0:
        raise SystemExit(f"{plan}: CUDA error {err}")
    return out, lse


def _flow_ptxas(fa):
    """Registers, spills and stack of the long-Q kernel and of the long-KV
    K1 `<6>` and `<8>`; the long-Q kernel's shared memory and ring slots."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(fa._CSRC))), "build",
                        "forms", "flow")
    os.makedirs(root, exist_ok=True)
    for source, marks in (("flash_attention_fwd_longq_sm90.cu", ("longq",)),
                          ("flash_attention_fwd_longkv_sm90.cu", ("ILi6E", "ILi8E"))):
        proc = subprocess.run(
            [fa._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
             os.path.join(root, "ptxas.so"), os.path.join(fa._CSRC, source)],
            capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc exit {proc.returncode}\n{proc.stderr[-4000:]}")
        kernel = None
        for line in (proc.stdout + proc.stderr).splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                kernel = entry.group(1)
            elif (kernel and "kernel" in kernel and any(m in kernel for m in marks)
                  and ("Used" in line or "spill" in line or "wgmma" in line)):
                print(f"[forms] ptxas {kernel}: {line.split('info    :')[-1].strip()}",
                      flush=True)
    lib = ctypes.CDLL(fa.library_paths()["fwd_longq"])
    fn = lib.flash_attention_fwd_longq_smem
    fn.argtypes = (ctypes.POINTER(ctypes.c_int),) * 2
    a, b = ctypes.c_int(0), ctypes.c_int(0)
    smem = fn(ctypes.byref(a), ctypes.byref(b))
    print(f"[forms] long-Q smem {smem} B, K ring {a.value}, V ring {b.value}", flush=True)


def run_flow(forms) -> None:
    """The flow sites' K1 forms ``forms``: each checked on the masked cases
    of its route, then timed at batch 1 and 6 (two readings each)."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
    from perceiverio_pytorch_tpu_torch.tools.kernel_report import _case, _window_ms

    fa.build()
    _flow_ptxas(fa)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for form in forms:
        checks = []
        for shape in FLOW_MASKED:
            (q, k, v), kw = _case(*shape, torch.bfloat16, True, False, gen)
            kw["kv_logical_len"] = shape[2] - 50
            plan = _flow_plan(form, q, k, v, kw["kv_logical_len"])
            got, lse = _flow_call(plan, q, k, v, kw)
            again, again_lse = _flow_call(plan, q, k, v, kw)
            want, want_lse = fa.flash_attention_reference(
                q.float(), k.float(), v.float(), return_lse=True, **kw)
            torch.cuda.synchronize()
            rel = ((got.float() - want).abs().max() / want.abs().max()).item()
            finite = torch.isfinite(want_lse)
            lse_err = (lse[finite] - want_lse[finite]).abs().max().item()
            wiped = ~kw["q_mask"]
            wiped[-1] = True
            ok = (torch.equal(finite, torch.isfinite(lse))
                  and got.view(*wiped.shape, -1)[wiped].abs().max().item() == 0
                  and torch.equal(got, again) and torch.equal(lse, again_lse))
            checks.append(f"{shape} rel {rel:.3g} lse {lse_err:.3g}"
                          f"{'' if ok and rel < 2e-2 and lse_err < 1e-4 else ' FAILED'}")
            del q, k, v, got, again, want
        times = []
        site = FLOW_DECODER if form.startswith("decoder") else FLOW_ENCODER
        for b in (1, 6):
            (q, k, v), _ = _case(b, *site[1:], torch.bfloat16, False, False, gen)
            plan = _flow_plan(form, q, k, v, k.shape[1])
            call = lambda: _flow_call(plan, q, k, v, {})  # noqa: E731
            ms = [_window_ms(call, 3, 30.0)[0] for _ in range(2)]
            times.append(f"batch {b}: {ms[0]:.4f}/{ms[1]:.4f} ms (splits {plan['splits']},"
                         f" blocks {plan.get('blocks', '-')})")
            del q, k, v
            torch.cuda.empty_cache()
        print(f"[forms] {form} ({FLOW_FORMS[form]}): {'; '.join(checks)}; {'; '.join(times)}",
              flush=True)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--one"]:
        run_form(argv[1])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("longkv_forms needs a CUDA device")
    if argv[:1] == ["flow"] or (argv and all(n in FLOW_FORMS for n in argv)):
        forms = [n for n in argv if n in FLOW_FORMS] or list(FLOW_FORMS)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"[forms] {smi.stdout.strip()}", flush=True)
        run_flow(forms + [forms[0]] if len(forms) > 1 else forms)
        return
    groups = {kernel: [n for n in FORMS if _kernel(n) == kernel] + [_KEPT[kernel]]
              for kernel in _KEPT}
    if not argv:
        names = groups["K2/K3"] + groups["K1"]
    elif argv in (["k1"], ["bwd"]):
        names = groups["K1" if argv == ["k1"] else "K2/K3"]
    else:
        names = argv
    unknown = [n for n in names if n not in FORMS]
    if unknown:
        raise SystemExit(f"unknown forms {unknown}; choose from {list(FORMS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[forms] {smi}", flush=True)
    for name in names:
        subprocess.run([sys.executable, "-m", "perceiverio_pytorch_tpu_torch.tools.longkv_forms",
                        "--one", name], check=True)


if __name__ == "__main__":
    main()
