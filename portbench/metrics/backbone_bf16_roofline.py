"""Kernels: K2, the bf16 backbone (``backbone_bf16_kernel`` and the gate
embed's ``embed_kernel``), as a share of its roofline, in %. One launch
does, for every cutout row: layer 1 in f32, convs 2-6 and the embed in
bf16; it reads the f32 cutouts and the weights and writes the bf16 features
and embeddings."""

from portbench import counts as c


def read(ctx):
    n, cut = c.rows(ctx), int(ctx["cfg"]["cutout"]["num_cutout_pts"])
    d = c.feat_dim(cut)
    ops = {"f32": n * c.layer1_ops(cut),
           "bf16": n * (c.backbone_tail_ops(cut) + c.embed_ops(cut))}
    weights = 2 * (c.backbone_tail_params() + d * c.EMBED)
    nbytes = n * (4 * cut + 2 * d + 2 * c.EMBED) + weights
    return c.roofline_pct(ctx["trace"], ("backbone_bf16_kernel",
                                         "embed_kernel"),
                          "backbone_bf16_kernel", ops, nbytes)
