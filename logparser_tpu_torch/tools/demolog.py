"""Synthetic access-log generator (the port's own copy of the reference
package's ``tools/demolog.py``: the same lines for the same seed).

The reference ships a 3456-line real ``combined`` access log
(examples/demolog/hackers-access.log) as golden/bench data.  We generate a
deterministic synthetic corpus with the same statistical shape instead:
realistic IPs, increasing timestamps, encoded + messy query strings, CLF null
bytes, quoted user agents, and a configurable fraction of hostile lines.
"""
from __future__ import annotations

import random
from typing import List

_METHODS = ["GET"] * 8 + ["POST", "HEAD"]
_PATHS = [
    "/", "/index.html", "/apache_pb.gif", "/icons/blank.gif",
    "/login.html", "/api/v1/items", "/search", "/images/logo%20big.png",
    "/a/very/deep/path/with/many/segments/page.html",
]
_QUERIES = [
    "", "", "", "?lang=nl&ref=home", "?q=caf%C3%A9", "?id=123&x=",
    "?a=1&b=2&c=3&utm_source=news", "?broken=50%-off", "?empty",
]
_UAS = [
    "Mozilla/5.0 (X11; Linux x86_64; rv:109.0) Gecko/20100101 Firefox/115.0",
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 (KHTML, like Gecko) Chrome/120.0 Safari/537.36",
    "Mozilla/4.08 [en] (Win98; I ;Nav)",
    "curl/8.0.1",
    "Googlebot/2.1 (+http://www.google.com/bot.html)",
    "-",
]
_REFERERS = [
    "-", "-", "http://www.example.com/start.html",
    "https://www.google.com/search?q=logparser&ie=utf-8",
    "http://localhost/index.php?mies=wim",
]
_MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
           "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
_GARBAGE = [
    '"\\x16\\x03\\x01"',
    "GET / HTTP/1.1",
    "completely broken line",
]


def generate_combined_lines(
    n: int,
    seed: int = 42,
    garbage_fraction: float = 0.0,
) -> List[str]:
    rng = random.Random(seed)
    lines: List[str] = []
    epoch_min = 0
    for i in range(n):
        if garbage_fraction > 0 and rng.random() < garbage_fraction:
            lines.append(rng.choice(_GARBAGE))
            continue
        ip = f"{rng.randint(1, 223)}.{rng.randint(0, 255)}.{rng.randint(0, 255)}.{rng.randint(1, 254)}"
        user = "-" if rng.random() < 0.9 else f"user{rng.randint(1, 99)}"
        epoch_min += rng.randint(0, 2)
        day = 1 + (epoch_min // 1440) % 28
        month = _MONTHS[(epoch_min // 40320) % 12]
        hh = (epoch_min // 60) % 24
        mm = epoch_min % 60
        ss = rng.randint(0, 59)
        tz = rng.choice(["+0100", "-0700", "+0000", "+0530"])
        ts = f"{day:02d}/{month}/2026:{hh:02d}:{mm:02d}:{ss:02d} {tz}"
        method = rng.choice(_METHODS)
        uri = rng.choice(_PATHS) + rng.choice(_QUERIES)
        proto = rng.choice(["HTTP/1.1"] * 8 + ["HTTP/1.0", "HTTP/2.0"])
        status = rng.choice(["200"] * 8 + ["404", "302", "500"])
        size = "-" if rng.random() < 0.1 else str(rng.randint(100, 5_000_000))
        referer = rng.choice(_REFERERS)
        ua = rng.choice(_UAS)
        lines.append(
            f'{ip} - {user} [{ts}] "{method} {uri} {proto}" {status} {size} '
            f'"{referer}" "{ua}"'
        )
    return lines


# The benchmark-of-record field set (bench.py and the device profiler
# both import it, so they can never measure different parsers).
HEADLINE_FIELDS = [
    "IP:connection.client.host",
    "STRING:connection.client.user",
    "TIME.EPOCH:request.receive.time.epoch",
    "HTTP.METHOD:request.firstline.method",
    "HTTP.URI:request.firstline.uri",
    "STRING:request.status.last",
    "BYTES:response.body.bytes",
    "HTTP.URI:request.referer",
    "HTTP.USERAGENT:request.user-agent",
]
