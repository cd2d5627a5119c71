"""dr_roofline.train, dr_roofline.serve: B1 + B2 + B3 together, their least
time at the traced slice's calls over the device time of all their
kernels, in %.  A call of B1 is its main kernel (a summing launch may
follow), of B2 its small body or its Gram launch (the split body's update
follows), of B3 its one launch."""

FAMILIES = {
    "fused_transform": (("fused_transform_kernel", "fused_transform_dense_kernel"),
                        ("fused_transform",)),
    "ternary_matmul": (("ternary_matmul",), ("ternary_matmul",)),
    "easi": (("easi_small_kernel", "easi_gram_kernel"), ("easi_",)),
}


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    bound = busy = 0.0
    for fam, (calls, every) in FAMILIES.items():
        ks = [k for k in tr.kernels() if any(n in k.name for n in every)]
        n = sum(1 for k in ks if any(c in k.name for c in calls))
        if n:
            bound += n * ctx["dr_bound_s"][fam]
        busy += sum(k.end - k.start for k in ks) / 1e6
    if bound <= 0 or busy <= 0:
        return None
    return 100.0 * bound / busy
