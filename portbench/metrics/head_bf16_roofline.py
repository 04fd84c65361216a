"""Kernels: K4, the bf16 head (``head_bf16_kernel``), as a share of its
roofline, in %. One launch does, for every cutout row: the head's five
convs in bf16 and its two linear maps in f32; it reads the bf16 template
and the weights and writes the f32 logit and vote."""

from portbench import counts as c


def read(ctx):
    n, cut = c.rows(ctx), int(ctx["cfg"]["cutout"]["num_cutout_pts"])
    ops = {"bf16": n * c.head_conv_ops(cut), "f32": n * c.head_linear_ops()}
    weights = 2 * c.head_conv_params()
    nbytes = n * (2 * c.feat_dim(cut) + 4 * 3) + weights
    return c.roofline_pct(ctx["trace"], ("head_bf16_kernel",),
                          "head_bf16_kernel", ops, nbytes)
