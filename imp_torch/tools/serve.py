"""Serve an artifact of the PyTorch port over HTTP: either kind
(``mbtrain`` or ``generic``), through its exported program, with no model
code.

Usage:
    python -m imp_torch.tools.serve --artifact DIR \
        [--host 127.0.0.1] [--port 8500] [--device cuda|cpu]

    curl localhost:8500/health
    curl -X POST localhost:8500/predict -d '{
        "batch": {"img": [[[...512 floats...], ...]], "mol": [[...]]},
        "risk": true}'

``GET /health`` reports the artifact's kind, model, task and shapes.
``batch.img`` may be ragged (per-slide [n_i, d] bags; the server pads and
masks them to the exported bag length); any batch size is accepted and
chunked to the exported batch size.  The program runs on ``--device``
(default ``cuda``); ``risk`` is answered for a Survival artifact only.
"""

from __future__ import annotations

import argparse


def main(args) -> None:
    from imp_torch.serving import make_http_server

    server = make_http_server(args.artifact, host=args.host, port=args.port,
                              device=args.device)
    m = server.serving_model.manifest
    host, port = server.server_address[:2]
    print(
        f"serving {m['model']} ({m['kind']}, {m['task']}, batch {m['batch_size']}, "
        f"attention {m['attention']}, device {args.device}) on "
        f"http://{host}:{port} — GET /health, POST /predict",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--artifact", required=True,
                        help="directory written by imp_torch.tools.export_model")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(parser.parse_args())
