"""Which device kernels belong to which kernel of the port, by base name,
and their library counters (shared by the kernel readers)."""

# kernel A: its products (bf16 or W8A8), the W8A8 row quantiser, its
# attention and its row kernels, each with the library's own counter
KERNEL_A = {"gemm_bf16_wgmma": "kernel.gemm_bf16",
            "gemm_int8_wgmma": "kernel.gemm_int8",
            "quantize_rows": "kernel.quantize_rows",
            "attention": "kernel.attention",
            "rows_first": "kernel.rows_first",
            "rows_residual": "kernel.rows_residual",
            "rows_boundary": "kernel.rows_boundary",
            "rows_last": "kernel.rows_last"}
KERNEL_E = ("row_topk_narrow", "row_topk_wide", "row_topk_block")


def kernel_a_s(trace):
    names = [n for n in KERNEL_A
             if trace.counted.get(KERNEL_A[n], 0) or n in trace.kernels]
    return trace.kernel_time(names, counter=KERNEL_A.get)


def kernel_e_s(trace):
    names = [n for n in KERNEL_E if n in trace.kernels]
    recorded = sum(trace.kernels[n][0] for n in names)
    counted = trace.counted.get("call.row_topk", 0)
    if counted and not recorded:
        return None
    secs = sum(trace.kernels[n][1] for n in names)
    return secs * counted / recorded if recorded and recorded < counted else secs


def all_kernels_s(trace):
    a = kernel_a_s(trace)
    e = kernel_e_s(trace)
    if a is None or e is None:
        return None
    rest = sum(v[1] for k, v in trace.kernels.items()
               if k not in KERNEL_A and k not in KERNEL_E)
    return a + e + rest
