"""Serve an exported artifact over HTTP.

Port of ``eovax/cli/serve.py``. Usage:

    python -m eovax_torch.cli.serve artifact/ [--host 0.0.0.0] [--port 8000] \
        [--warmup 1 8] [--max-batch 16] [--device cuda]

Loads the artifact with ``ServedModel.load`` onto the card (no model code
needed), optionally fans it out data-parallel over every visible card
(``--mesh``; with ``--device cpu`` a one-device mesh of the host), warms the
requested batch sizes, then blocks on ``serve_forever`` until SIGTERM (or
Ctrl-C), which shuts it down cleanly. Protocol: see
eovax_torch/serving/server.py.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Serve an EO-VAE artifact over HTTP")
    parser.add_argument("artifact", help="directory from eovax_torch.cli.export")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000,
                        help="0 binds an ephemeral port (printed at startup)")
    parser.add_argument("--mesh", action="store_true",
                        help="split request batches data-parallel over all "
                        "visible cards (ServedModel.with_mesh). One host thread "
                        "issues every card's graph in turn: at small batches this "
                        "serves fewer requests/s than one card (PERF.md)")
    parser.add_argument("--warmup", type=int, nargs="*", default=[1],
                        help="batch sizes to call once before serving (default: 1; "
                        "pass no values to skip)")
    parser.add_argument("--max-batch", type=int, default=0,
                        help="enable dynamic micro-batching: coalesce "
                        "concurrent requests into device batches up to this "
                        "size (0 = off; super_resolve batches only on "
                        "per-sample-seed artifacts)")
    parser.add_argument("--batch-wait-ms", type=float, default=3.0,
                        help="micro-batching window: how long the first "
                        "request in a batch waits for company")
    parser.add_argument("--verbose", action="store_true",
                        help="log one line per request")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from eovax_torch.serving import ServedModel
    from eovax_torch.serving.server import make_server, warmup

    served = ServedModel.load(args.artifact, device=args.device)
    warm_batches = list(args.warmup)
    if args.mesh:
        from eovax_torch.parallel.mesh import make_device_mesh

        mesh = make_device_mesh(None if served.device.type == "cuda" else [served.device])
        served = served.with_mesh(mesh)
        n = mesh.size
        print(f"data-parallel over {n} devices")
        # Traffic whose batch the device count divides takes the split path;
        # warm it too, or the first such batch meets cold cuDNN choices.
        if warm_batches and not any(b % n == 0 for b in warm_batches):
            warm_batches.append(n)
    httpd = make_server(served, host=args.host, port=args.port,
                        quiet=not args.verbose, max_batch=args.max_batch,
                        batch_wait_ms=args.batch_wait_ms)
    if httpd.batcher is not None:
        print(f"micro-batching on: max_batch={args.max_batch}, "
              f"window={args.batch_wait_ms} ms, "
              f"buckets={httpd.batcher.buckets}")
    warmed = []
    if warm_batches:
        warmed += warmup(served, batch_sizes=tuple(warm_batches))
    if httpd.batcher is not None and args.warmup:
        # Warm the bucket ladder for the BATCHABLE functions only: batched
        # traffic dispatches at bucket sizes, and cuDNN chooses its
        # algorithms at the first call of each size. A super_resolve without
        # per-sample seeds never batches; ServedModel.batchable decides. An
        # explicit `--warmup` with no values skips all warmup, buckets
        # included (operator's call).
        extra = sorted(set(httpd.batcher.buckets) - set(warm_batches))
        if extra:
            batchable = {n for n in
                         {k.split(".")[0]
                          for k in served._manifest["functions"]}
                         if served.batchable(n)}
            warmed += warmup(served, batch_sizes=tuple(extra),
                             functions=batchable)
    if warmed:
        print(f"warmed {len(warmed)} function×batch combinations")
    host, port = httpd.server_address[:2]
    fns = ", ".join(sorted(served._manifest["functions"]))
    print(f"serving {fns} on http://{host}:{port}/v1/ (GET /healthz, "
          "GET /v1/manifest)", flush=True)
    # Graceful SIGTERM: shutdown() must come from another thread than
    # serve_forever (it blocks until the serve loop exits).
    import signal
    import threading

    prev_term = signal.signal(
        signal.SIGTERM,
        lambda s, f: threading.Thread(target=httpd.shutdown, daemon=True).start(),
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # close the listening socket and drop our handler even if the
        # serve loop died on an exception (port would stay bound, and a
        # later SIGTERM would hit a shutdown thread for a dead server)
        httpd.server_close()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    print("shut down", flush=True)


if __name__ == "__main__":
    main()
