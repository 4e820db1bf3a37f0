"""The load generator: a separate process that imports no torch (the
standard library only) and sends POST /generate to the server on
127.0.0.1.

Protocol over standard input and output, one JSON line each way:
  -> "ready"
  <- {"port", "t0" (time.monotonic() of the window's start), "loop":
      "open" | "closed", "requests": [body, ...], "timeout",
      open: "due": [seconds after t0, ...];
      closed: "clients", "stop_at" (monotonic: no request starts after it)}
  -> {"results": [{"i", "due", "sent", "done", "status", "bytes", "error"
      (the reply's first 300 bytes, or the exception, when it was no wav)},
      ...]}
  <- {"indices": [i, ...]}
  -> {"<i>": base64 of the reply's wav, ...}
Open loop: request i is sent at t0 + due[i] whatever the server does, on a
connection of its own, and `sent - due` is how late the sender ran. Closed
loop: each client keeps one keep-alive connection and sends its next
request on it as soon as its reply arrives, until stop_at. A request is
sent once: a connection that is refused, reset or closed without a reply
fails it (status -1), and nothing is retried."""

import base64
import http.client
import json
import sys
import threading
import time


def post(conn: http.client.HTTPConnection, body: dict):
    """(status, body) of one POST /generate on `conn`."""
    conn.request("POST", "/generate", body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, r.read()


def main() -> None:
    print("ready", flush=True)
    plan = json.loads(sys.stdin.readline())
    port, t0, reqs, timeout = plan["port"], plan["t0"], plan["requests"], plan["timeout"]
    results, wavs, lock = {}, {}, threading.Lock()

    def connect():
        return http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)

    def one(conn, i: int, due: float) -> bool:
        """Sends request i on conn; False when the connection failed."""
        sent = time.monotonic()
        try:
            status, data = post(conn, reqs[i])
        except (OSError, http.client.HTTPException) as e:  # refused, reset, cut: failed
            status, data = -1, repr(e).encode()
        done = time.monotonic()
        with lock:
            results[i] = {"i": i, "due": due, "sent": sent, "done": done, "status": status,
                          "bytes": len(data)}
            if status == 200:
                wavs[i] = data
            else:
                results[i]["error"] = data[:300].decode("utf-8", "replace")
        return status != -1

    def single(i: int, due: float) -> None:
        conn = connect()
        try:
            one(conn, i, due)
        finally:
            conn.close()

    threads = []
    if plan["loop"] == "open":
        for i, d in enumerate(plan["due"]):
            delay = t0 + d - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=single, args=(i, t0 + d), daemon=True)
            th.start()
            threads.append(th)
    else:
        nxt = [0]

        def client() -> None:
            conn = connect()
            try:
                while time.monotonic() < plan["stop_at"]:
                    with lock:
                        i = nxt[0]
                        nxt[0] += 1
                    if i >= len(reqs):
                        return
                    if not one(conn, i, time.monotonic()):
                        conn.close()
                        conn = connect()
            finally:
                conn.close()

        delay = t0 - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        threads = [threading.Thread(target=client, daemon=True) for _ in range(plan["clients"])]
        for th in threads:
            th.start()
    for th in threads:
        th.join(timeout + 5.0)
    with lock:
        out = [results[i] for i in sorted(results)]
    print(json.dumps({"results": out}), flush=True)
    want = json.loads(sys.stdin.readline())
    print(json.dumps({str(i): base64.b64encode(wavs[i]).decode()
                      for i in want["indices"] if i in wavs}), flush=True)


if __name__ == "__main__":
    main()
