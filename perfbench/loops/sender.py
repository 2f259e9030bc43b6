"""One client process of the open loop: sends its share of the schedule.

Reads one JSON object on standard input: ``url``, ``start`` (the
``time.monotonic()`` instant of schedule time 0; the clock is the
machine's, shared by every process) and ``requests``, a list of ``[index,
due offset in s, query, topk]``.  Each request is handed to a thread of its
own at its due time, whatever is still in flight, and is timed from the
due time to the reply's last byte.  Writes one JSON line per request on
standard output: index, due, sent and done (monotonic seconds), the HTTP
status (0 when no reply came), and the reply's ids and scores.
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from urllib.parse import urlparse

REPLY_TIMEOUT_S = 120.0


def one(url, req, out, lock):
    index, due, query, topk = req
    u = urlparse(url)
    sent = time.monotonic()
    status, ids, scores = 0, None, None
    try:
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=REPLY_TIMEOUT_S)
        body = json.dumps({"queries": [query], "topk": topk})
        conn.request("POST", "/search", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = resp.read()
        status = resp.status
        if status == 200:
            r = json.loads(payload)["results"][0]
            ids, scores = r["ids"], r["scores"]
        conn.close()
    except Exception:  # no reply: counted as failed by the harness
        status = 0
    done = time.monotonic()
    with lock:
        out.append({"index": index, "due": due, "sent": sent, "done": done, "status": status,
                    "ids": ids, "scores": scores})


def main() -> int:
    job = json.loads(sys.stdin.read())
    start, url = job["start"], job["url"]
    out, lock, threads = [], threading.Lock(), []
    for req in job["requests"]:
        due = start + req[1]
        wait = due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        t = threading.Thread(target=one, args=(url, [req[0], due, req[2], req[3]], out, lock), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(REPLY_TIMEOUT_S + 5)
    with lock:
        for row in out:
            sys.stdout.write(json.dumps(row) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
