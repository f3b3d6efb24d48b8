"""Device operations by group: a copy of scripts/torch_profile_request.py's
`GROUPS` table and `group_of`, kept here so that a change to the program
cannot move the benchmark's grouping."""

from __future__ import annotations

# Kernel-name fragments -> group, first match wins: the int8 GEMM's instances
# (hgemm::gemm_kernel<policy>) by their epilogue policy, before the "gemm"
# fragment of the library's kernels. The two row quantisers serve two
# kernels each (`row_quant_kernel` F and I, `ln_quant_kernel` G and H).
GROUPS = (
    ("hattn::resident_kernel", "kernel A flash_mha_short"),
    ("row_quant_kernel", "int8 row quantisation (F, G, H, I)"),
    ("ln_quant_kernel", "int8 row quantisation (F, G, H, I)"),
    ("Act8Out", "kernel F act8_gemm"),
    ("QkvOut", "kernel G fused_ln_qkv_int8"),
    ("RowAmax", "kernel H fused_ln_mlp_int8"),
    ("QuantStore", "kernel H fused_ln_mlp_int8"),
    ("ScaleOfAmax", "kernel H fused_ln_mlp_int8"),
    ("ScaleGiven", "kernel I fused_proj_residual_int8"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
    ("nvjet", "library GEMMs"),
    ("gemm", "library GEMMs"),
    ("cutlass", "library GEMMs"),
    ("cublas", "library GEMMs"),
)
# Rows of the tracer's own bookkeeping: no work of the program.
TRACER_ROWS = ("Command Buffer Full", "Activity Buffer Request")
OTHER = "other PyTorch kernels (elementwise, reductions, casts)"


def group_of(name: str) -> str:
    # stream_kernel<DP, kTwoPass, kLse, Policy, order>: with segment ids J's
    # forward (the lse store) or else kernel K; with the key mask kernel C
    # with the lse store, A in its two-pass mode beyond resident K, else B.
    if "hattn::stream_kernel" in name:
        if "SegmentIds" in name:
            return ("kernel J flash_segment_fwd" if ", false, true," in name
                    else "kernel K splash_mqa")
        if ", false, true," in name:
            return "kernel C flash_train_fwd"
        return "kernel A flash_mha_short" if ", true, false," in name else "kernel B flash_mha"
    if "hattn::dq_kernel" in name:
        return ("kernel J flash_segment_dq" if "SegmentIds" in name
                else "kernel D flash_train_dq")
    if "hattn::dkv_kernel" in name:
        return ("kernel J flash_segment_dkv" if "SegmentIds" in name
                else "kernel E flash_train_dkv")
    for fragment, group in GROUPS:
        if fragment in name:
            return group
    return OTHER
