"""kernels.k2_p_reads_per_particle (fraction): the P_base matrices that K2
read in one engine call, over N_P times its K2 launches: 1 where every
particle reads its own, the share of distinct bases where each run of
equal bases is read once. The count is the program's own (K2's float32
form adds it on the device inside ``recording()``; it lands in the call's
root span as ``k2_p_reads``), from the call of spans.py. None where no
span holds the count: a program without it, or another form of K2."""

from benchmark import spans


def read(ctx):
    call = spans.call_of(ctx)
    if call is None:
        return None
    reads = launches = 0
    for s in call.spans:
        count = getattr(s, "k2_p_reads", None)
        if count is not None:
            reads += count
            launches += s.launches.get("gather_cp", 0)
    if not launches:
        return None
    return reads / (ctx.cell.n * launches)
