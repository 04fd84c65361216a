"""Kernels: K7, the int8 head (``head_int8_kernel``), as a share of its
roofline, in %. One launch does, for every cutout row: the head's five
convs in int8 and its two linear maps in f32; it reads the int8 template
and the weights and writes the f32 logit and vote."""

from portbench import counts as c


def read(ctx):
    n, cut = c.rows(ctx), int(ctx["cfg"]["cutout"]["num_cutout_pts"])
    ops = {"int8": n * c.head_conv_ops(cut), "f32": n * c.head_linear_ops()}
    weights = c.head_conv_params()
    nbytes = n * (c.feat_dim(cut) + 4 * 3) + weights
    return c.roofline_pct(ctx["trace"], ("head_int8_kernel",),
                          "head_int8_kernel", ops, nbytes)
