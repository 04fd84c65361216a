"""Kernels: K5, the int8 backbone (``backbone_int8_kernel`` and the gate
embed's ``embed_kernel``), as a share of its roofline, in %. One launch
does, for every cutout row: layer 1 in f32, convs 2-6 in int8, the embed in
bf16; it reads the f32 cutouts and the weights and writes the int8 features
and the bf16 embeddings."""

from portbench import counts as c


def read(ctx):
    n, cut = c.rows(ctx), int(ctx["cfg"]["cutout"]["num_cutout_pts"])
    d = c.feat_dim(cut)
    ops = {"f32": n * c.layer1_ops(cut), "int8": n * c.backbone_tail_ops(cut),
           "bf16": n * c.embed_ops(cut)}
    weights = c.backbone_tail_params() + 2 * d * c.EMBED
    nbytes = n * (4 * cut + d + 2 * c.EMBED) + weights
    return c.roofline_pct(ctx["trace"], ("backbone_int8_kernel",
                                         "embed_kernel"),
                          "backbone_int8_kernel", ops, nbytes)
