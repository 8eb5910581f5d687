"""``tail_conv_roofline_pct.<kind>[.<regime>]``: the least time of the
convs the fused tail's kernels run, over the card time of the kernels
below in the traced window, in %. A pass's least time is the larger of
its useful FLOPs over the peak (495 TFLOP/s for fp32 work, which runs
3xTF32) and its bytes, each read or written once, over 3.35 TB/s
(``nqbench/work``); a decode runs the forward of the decoder's last convs,
a training step their forward, input gradient and weight gradient. None
where no such kernel ran."""

# the fused tail's conv kernels and their split-K reductions
KERNELS = ("tail_conv_cf_kernel", "tail_conv_cf_finish_kernel",
           "tail_conv_dw_cf_kernel", "dw_reduce_kernel")


def read(name, ctx):
    least = ctx["work"].get("tail_least_s")
    if name.split(".")[1:2] != [ctx["kind"]] or not least:
        return None
    spent = ctx["trace"].time_of(KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least * ctx["steps"] / spent
