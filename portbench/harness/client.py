"""The benchmark's load generator: a process of its own, so that its work
never competes for the server's interpreter lock. It imports only the
standard library.

Protocol over its standard input and output, one JSON line each way:

  in : {"port", "path", "clients": [[{"query", "start", "end", "step"
        [, "at"]}, ...], ...], "timeout_s"}
  out: "ready"
  in : {"go": t0, "until": t1}      (time.monotonic() of this host)
  out: {"records": [[client, index, t_send, t_done, status, nbytes], ...]}
  in : {"keep": [[client, index], ...]}
  out: {"bodies": {"client:index": "<response body>"}}

Each client is one thread on one keep-alive HTTP/1.1 connection: it sends
the next request of its own sequence when the last answer is in, and
sends none at or after `until`. A request that carries `at` (an open
loop's arrival) is not sent before `go + at`, and its time of sending is
that arrival, so that a late answer's wait counts in the next request's
latency. A request sent before `until` is waited for, up to `timeout_s`;
status 0 marks one that failed on the socket or timed out.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import time
import urllib.parse


class KeepAlive:
    """One persistent HTTP/1.1 connection speaking raw sockets with
    pre-built request bytes, so that the client measures the server and
    not http.client's object machinery."""

    def __init__(self, port: int, timeout_s: float):
        self.port = port
        self.timeout_s = timeout_s
        self.sock = None
        self.buf = b""

    def _connect(self) -> None:
        self.sock = socket.create_connection(("127.0.0.1", self.port),
                                             timeout=self.timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.buf = b""

    def get(self, target: str):
        """-> (HTTP status, body bytes)."""
        req = (f"GET {target} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
               f"Accept-Encoding: identity\r\n\r\n").encode()
        if self.sock is None:
            self._connect()
        self.sock.sendall(req)
        while b"\r\n\r\n" not in self.buf:
            self._recv()
        head, self.buf = self.buf.split(b"\r\n\r\n", 1)
        lines = head.split(b"\r\n")
        status = int(lines[0].split()[1])
        clen = 0
        for ln in lines[1:]:
            k, _, v = ln.partition(b":")
            if k.strip().lower() == b"content-length":
                clen = int(v.strip())
        while len(self.buf) < clen:
            self._recv()
        body, self.buf = self.buf[:clen], self.buf[clen:]
        return status, body

    def _recv(self) -> None:
        chunk = self.sock.recv(1 << 20)
        if not chunk:
            raise OSError("connection closed mid-response")
        self.buf += chunk

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        self.sock = None
        self.buf = b""


def run_client(c: int, port: int, path: str, seq: list, go: float,
               until: float, timeout_s: float, records: list,
               bodies: dict) -> None:
    conn = KeepAlive(port, timeout_s)
    targets = [path + "?" + urllib.parse.urlencode(
        {"query": r["query"], "start": r["start"], "end": r["end"],
         "step": r["step"]}) for r in seq]
    try:
        for i, target in enumerate(targets):
            t_send = time.monotonic()
            if "at" in seq[i]:
                t_send = go + seq[i]["at"]
                if t_send < until:
                    time.sleep(max(0.0, t_send - time.monotonic()))
            if t_send >= until:
                return
            try:
                status, body = conn.get(target)
            except OSError:
                conn.close()
                status, body = 0, b""
            t_done = time.monotonic()
            records.append([c, i, t_send, t_done, status, len(body)])
            bodies[(c, i)] = body
        raise RuntimeError(f"client {c} ran out of requests: the plan "
                           f"holds too few for the window")
    finally:
        conn.close()


def main() -> int:
    plan = json.loads(sys.stdin.readline())
    out = sys.stdout
    out.write("ready\n")
    out.flush()
    go = json.loads(sys.stdin.readline())
    per_client = [[] for _ in plan["clients"]]
    bodies: dict = {}
    errors: list = []

    def body(c: int) -> None:
        try:
            run_client(c, plan["port"], plan["path"], plan["clients"][c],
                       go["go"], go["until"], plan["timeout_s"],
                       per_client[c], bodies)
        except Exception as e:      # reported to the harness, which fails
            errors.append(f"client {c}: {e!r}")

    while time.monotonic() < go["go"]:
        time.sleep(min(0.001, max(0.0, go["go"] - time.monotonic())))
    threads = [threading.Thread(target=body, args=(c,), daemon=True)
               for c in range(len(plan["clients"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    records = [r for rs in per_client for r in rs]
    out.write(json.dumps({"records": records, "errors": errors}) + "\n")
    out.flush()
    keep = json.loads(sys.stdin.readline())["keep"]
    out.write(json.dumps({"bodies": {
        f"{c}:{i}": bodies[(c, i)].decode("utf-8", "replace")
        for c, i in keep}}) + "\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
