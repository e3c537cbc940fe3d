"""Serve an exported artifact over HTTP and query it with ServeClient.

End-to-end demo of the serving path: export (or reuse) an artifact, start
the stdlib HTTP host in this process on the card, then act as a client —
post a batch, print predictions + uncertainties, and scrape /metrics. In
production the server runs standalone (``multimodal-auv-torch-serve
--artifact DIR``) and clients live elsewhere; one process here keeps the
example self-contained.

    python examples/torch/example_serve.py --artifact /tmp/auv_art \
        [--tiny --allow_random_init] [--batch_window_ms 5]
"""
import _bootstrap  # noqa: F401  (source-checkout sys.path setup)

import argparse
import os
import threading

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--artifact", required=True,
                   help="artifact dir; exported here if it doesn't exist")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_mc_samples", type=int, default=20)
    p.add_argument("--model_weights", default=None)
    p.add_argument("--allow_random_init", action="store_true")
    p.add_argument("--batch_window_ms", type=float, default=0.0)
    _bootstrap.add_common(p, tiny_help="tiny architecture (demo without "
                                       "weights)")
    args = p.parse_args()

    if not os.path.exists(os.path.join(args.artifact, "meta.json")):
        from multimodal_auv_torch.pipelines import export_auv_serving_artifact

        export_auv_serving_artifact(
            output_dir=args.artifact, batch_size=args.batch_size,
            num_mc_samples=args.num_mc_samples,
            model_weights_path=args.model_weights,
            allow_random_init=args.allow_random_init,
            arch=_bootstrap.arch(args), device=args.device)

    from multimodal_auv_torch.serve_client import ServeClient
    from multimodal_auv_torch.serve_http import make_server

    server = make_server(args.artifact, "127.0.0.1", 0,
                         batch_window_ms=args.batch_window_ms,
                         device=args.device)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    c = ServeClient(f"http://{host}:{port}")
    print("healthz:", c.healthz())

    s = c.meta()["image_size"]
    rng = np.random.default_rng(0)
    n = args.batch_size
    out = c.predict(rng.integers(0, 255, (n, s, s, 3), np.uint8),
                    rng.integers(0, 255, (n, s, s, 3), np.uint8),
                    rng.integers(0, 255, (n, s, s, 1), np.uint8), seed=7)
    for i in range(n):
        label = (out["predicted_labels"][i] if "predicted_labels" in out
                 else int(out["predicted"][i]))
        print(f"sample {i}: class={label} "
              f"predictive={out['predictive_uncertainty'][i]:.4f} "
              f"aleatoric={out['aleatoric_uncertainty'][i]:.4f}")
    print("--- /metrics ---")
    print("\n".join(line for line in c.metrics_text().splitlines()
                    if not line.startswith("#")))
    server.shutdown()
    server.server_close()


if __name__ == "__main__":
    main()
