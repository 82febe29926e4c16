"""attn_roofline (%, moves audio_rtf): the sum of each attention
call's least time (``flops.attention_bound_s``: the larger of its
``4 BH N^2 D`` operations over the peak of its dtype and its Q, K, V and
O bytes over the bandwidth) over the device time of the kernels launched
under the ``mha`` spans, in percent.  Nothing to read where no call was
made."""
from perfbench.harness.flops import attention_bound_total_s


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.attn_calls or not len(t.dev):
        return None
    busy = t.device_time("pb.mha")
    if busy <= 0:
        return None
    return 100.0 * attention_bound_total_s(ctx.attn_calls, ctx.peaks()) / busy
