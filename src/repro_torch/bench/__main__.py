"""CLI: run the registered sweeps on the card (or the CPU), optionally
persist BENCH_torch_<timestamp>.json.

  PYTHONPATH=src python -m repro_torch.bench                  # card scale
  PYTHONPATH=src python -m repro_torch.bench --fast           # small sizes
  PYTHONPATH=src python -m repro_torch.bench --sweeps latency,stride
  PYTHONPATH=src python -m repro_torch.bench --fast --device cpu
  PYTHONPATH=src python -m repro_torch.bench --calibrate --out runs
"""
import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sweeps", default="",
                    help="comma-separated subset (default: all)")
    ap.add_argument("--fast", action="store_true",
                    help="the reference's small problem sizes")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the card; 'cpu' runs "
                         "the plain PyTorch versions)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated device group of the distributed "
                         "sweep (dist_serve); may repeat one, e.g. "
                         "cuda:0,cuda:0 (default: the visible cards)")
    ap.add_argument("--out", default="",
                    help="directory for BENCH_torch_<timestamp>.json "
                         "(default: no file)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit memmodel constants to the device first and "
                         "attach the calibration record to the run")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.bench import calibrate, run_sweeps

    device = resolve_device(args.device)
    calibration = None
    if args.calibrate:
        cal = calibrate(fast=args.fast, device=device)
        calibration = cal.to_dict()
        print(f"# calibrated on {device}: T_l={cal.spec.latency_s*1e9:.1f}ns "
              f"BW={cal.spec.hbm_bw/1e9:.2f}GB/s "
              f"(rms log err {cal.rms_log_error:.3f})", flush=True)

    names = [s for s in args.sweeps.split(",") if s] or None
    print(f"# device {device}")
    print("name,us_per_call,derived")
    run = run_sweeps(names=names, fast=args.fast, out_dir=args.out or None,
                     calibration=calibration, device=device,
                     devices=args.devices.split(",") if args.devices
                     else None)
    if "path" in run.env:
        print(f"# wrote {run.env['path']}", flush=True)
    if run.failures:
        print(f"# {len(run.failures)} sweep(s) FAILED: "
              f"{sorted(run.failures)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
