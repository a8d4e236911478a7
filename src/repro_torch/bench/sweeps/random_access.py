"""Paper Tables 7/8: random access (LFSR + pointer-chase) vs sequential.

The paper's headline ordering — sequential 421 GB/s >> LFSR-random 5.8
GB/s >> pointer-chase 0.99 GB/s on the FPGA — is the ratio structure
reproduced here through K4, K6 and K7.  At ``fast`` the reference's
sizes; on the card a 2^18 x 1024 float32 copy (1 GiB in, 1 GiB out),
2^20 random 64-byte rows out of 2^24 (1 GiB, the whole 24-bit LFSR
range), and a chase of 2^13 hops over 2^26 entries (256 MiB).
"""
from repro_torch.bench.registry import SweepContext, register
from repro_torch.core import engines
from repro_torch.core.patterns import Knobs, Pattern


@register("random", "Tables 7-8")
def run(ctx: SweepContext) -> None:
    fast = ctx.fast
    seq = engines.bw_sequential(rows=4096 if fast else 1 << 18, cols=1024,
                                spec=ctx.spec, device=ctx.device)
    # knobs mirror engines.bw_sequential's own model point so calibration
    # fits predict_bw at the measured configuration, not a nominal default
    ctx.emit("seq", pattern=Pattern.SEQUENTIAL,
             knobs=Knobs(unit_bytes=128 * 4, burst_bytes=1024 * 4 * 8,
                         outstanding=2),
             us=seq.wall_s * 1e6, bytes_moved=seq.bytes_moved,
             gbps_measured=seq.gbps_measured,
             gbps_predicted=seq.gbps_model,
             paper_u280_gbps=421.68,
             **{k: v for k, v in seq.extras.items()
                if k.startswith("kernel_")})
    r = None
    for gen in ("lfsr", "prng"):
        # one-sector-pair rows (64B ~ the paper's 256-bit units) from a
        # table far larger than the cache: each touch pays the latency
        r = engines.bw_random(n_rows=1 << (17 if fast else 24), cols=16,
                              n_idx=1 << (13 if fast else 20), generator=gen,
                              spec=ctx.spec, device=ctx.device)
        ctx.emit(f"random_{gen}", pattern=Pattern.RANDOM,
                 knobs=Knobs(unit_bytes=64, outstanding=8),
                 us=r.wall_s * 1e6, bytes_moved=r.bytes_moved,
                 gbps_measured=r.gbps_measured,
                 gbps_predicted=r.gbps_model,
                 paper_u280_gbps=5.82,
                 **{k: v for k, v in r.extras.items()
                    if k.startswith("kernel_")})
    chase = engines.latency_chase(n_entries=1 << (20 if fast else 26),
                                  steps=1 << 13, spec=ctx.spec,
                                  device=ctx.device)
    # the paper's ratio claim: seq >> random >> chase.  The chase relations
    # hold on any device (serialized loads cannot be hidden); the
    # seq-vs-random gap is reported, not asserted.
    hard = (seq.gbps_measured > chase.gbps_measured
            and r.gbps_measured > chase.gbps_measured)
    ctx.emit("random_pointer_chase", pattern=Pattern.CHASE,
             knobs=Knobs(unit_bytes=4, outstanding=1),
             us=chase.wall_s * 1e6, bytes_moved=chase.bytes_moved,
             gbps_measured=chase.gbps_measured,
             gbps_predicted=chase.gbps_model,
             paper_u280_gbps=0.994,
             chase_slowest=hard,
             seq_over_random=f"{seq.gbps_measured/r.gbps_measured:.2f}x",
             model_seq_over_random=f"{seq.gbps_model/r.gbps_model:.0f}x",
             ns_per_hop=chase.extras["ns_per_hop"],
             chain=chase.extras["chain"])
    if not hard:
        raise AssertionError("pointer chase must be slowest everywhere")
