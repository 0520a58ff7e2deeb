"""Synthetic access-log generator (the port's own copy of the reference
package's ``tools/demolog.py``: the same lines for the same seed).

The reference ships a 3456-line real ``combined`` access log
(examples/demolog/hackers-access.log) as golden/bench data.  We generate a
deterministic synthetic corpus with the same statistical shape instead:
realistic IPs, increasing timestamps, encoded + messy query strings, CLF null
bytes, quoted user agents, and a configurable fraction of hostile lines.
"""
from __future__ import annotations

import base64
import random
import re
from typing import List

import numpy as np

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



_LONG_PARTS = re.compile(r'^(.*?"\S+ )(\S+)( [^"]*" \S+ \S+ ")([^"]*)(" ")([^"]*)(")$')
_PAD_BYTES = np.frombuffer(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789", dtype=np.uint8)


def long_combined_lines(n: int, seed: int = 63, min_len: int = 8192,
                        max_len: int = 32000,
                        garbage_fraction: float = 0.01) -> List[str]:
    """``generate_combined_lines(n, seed, garbage_fraction)`` with each
    non-garbage line grown to a length drawn from [min_len, max_len] (a
    numpy RNG from ``seed``): the extra bytes, letters and digits, go to a
    ``pad=`` query parameter of the request URI, an ``r=`` parameter of
    the referer and the user-agent's tail, in random shares -- the lines
    of sites that raise ``LimitRequestLine`` /
    ``large_client_header_buffers`` for long ad-tech queries, cookies and
    referers.  Garbage lines stay as they are."""
    rng = np.random.default_rng(seed)
    out: List[str] = []
    for line in generate_combined_lines(n, seed=seed, garbage_fraction=garbage_fraction):
        m = _LONG_PARTS.match(line)
        if m is None:
            out.append(line)
            continue
        head, uri, mid, ref, sep, ua, tail = m.groups()
        # Nine bytes of separators come on top: '&' or '?' twice,
        # 'pad=', 'r=' and a space.
        extra = max(0, int(rng.integers(min_len, max_len + 1)) - len(line) - 9)
        cut = np.sort(rng.integers(0, extra + 1, size=2))
        pad = _PAD_BYTES[rng.integers(0, len(_PAD_BYTES), size=extra)].tobytes().decode()
        p_uri, p_ref, p_ua = pad[:cut[0]], pad[cut[0]:cut[1]], pad[cut[1]:]
        uri += ("&" if "?" in uri else "?") + "pad=" + p_uri
        ref += ("&" if "?" in ref else "?") + "r=" + p_ref
        ua += " " + p_ua
        out.append(head + uri + mid + ref + sep + ua + tail)
    return out


def force_escaped_quote_lines(base: List[str], pct: float) -> List[str]:
    """Copy of ``base`` with every ``round(100 / pct)``-th line's last
    quoted field (the user-agent) rewritten to start with a
    backslash-escaped quote (``"esc \\" quote <ua>"``): the reference
    bench's escaped-quote corpus."""
    step = max(1, round(100 / pct))
    out = list(base)
    for i in range(0, len(out), step):
        out[i] = re.sub(r'"([^"]*)"$', r'"esc \\" quote \1"', out[i], count=1)
    return out

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

# The URI dashboard field set: page path plus three campaign / search
# query keys (the reference's bench.py URI_DASHBOARD_FIELDS).
URI_DASHBOARD_FIELDS = [
    "HTTP.PATH:request.firstline.uri.path",
    "STRING:request.firstline.uri.query.q",
    "STRING:request.firstline.uri.query.utm_source",
    "STRING:request.firstline.uri.query.id",
]

# The URI chain end to end: the headline fields, the dashboard fields,
# every query parameter, the raw query string, the protocol split and the
# referer's authority and parameters.
URI_CHAIN_FIELDS = HEADLINE_FIELDS + URI_DASHBOARD_FIELDS + [
    "STRING:request.firstline.uri.query.*",
    "HTTP.QUERYSTRING:request.firstline.uri.query",
    "TIME.YEAR:request.receive.time.year",
    "HTTP.PROTOCOL:request.firstline.protocol",
    "HTTP.PROTOCOL.VERSION:request.firstline.protocol.version",
    "HTTP.HOST:request.referer.host",
    "HTTP.PORT:request.referer.port",
    "HTTP.PROTOCOL:request.referer.protocol",
    "STRING:request.referer.query.*",
]


def uri_edge_lines(max_len: int = 384) -> List[str]:
    """Crafted ``combined`` lines for the URI chain: absolute first-line
    URIs with userinfo and port, opaque and registry authorities, a
    20-digit port, '#', ';', two '?', bad escapes and encode-set bytes, a
    URI longer than the default 192-byte scan window, a query with 20
    parameters (past the default 16 slots) and one with more parameters
    than the 128-slot cap -- as many as fit a ``max_len``-byte line."""
    def line(uri: str, ref: str = "-") -> str:
        return (f'1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] "GET {uri} HTTP/1.1" '
                f'200 5 "{ref}" "u"')

    lines = [
        line("http://user:pw@example.com:8080/x/y?a=1&b=%41", "http://u@h.com:81/r?z=1"),
        line("/p", "mailto:someone@example.com"),
        line("http://[::1]:80/p?x=1", "http://[::1]/x?y=2"),
        line("/p", "http://h.com:12345678901234567890/x"),
        line("/p", "http://h.com:9223372036854775808/x"),
        line("/p#frag"),
        line("/p;jsessionid=1"),
        line("/p?a=1?b=2"),
        line("/p?broken=50%-off&q=caf%C3%A9&e=%zz&plus=a+b"),
        line("/p?x={y}&%41=1&n%2=v", "https://s.com/?q=a%20b&q=c"),
        line("/a%20b/c?", "urn:isbn:0451450523"),
        line("HTTP/1.1"),
        line("/" + "x" * 250 + "?y=1"),
        line("/p?" + "&".join(f"k{i}=v{i}" for i in range(20))),
        line("/p?a=1&A=2&a=3&=4&&k&" + "k" * 5 + "=%2B"),
        line("/p", "-"),
        line("/p", ""),
    ]
    base = len(line("/p?"))
    n = (max_len - base + 1) // 2
    lines.append(line("/p?" + "&".join("a" * n)))
    return lines


# The two strftime benchmark configurations of the reference package's
# bench.py: mod_logio's ``combinedio`` with a strftime timestamp, and zone
# names in place of numeric offsets.
COMBINEDIO_STRFTIME_FORMAT = (
    '%h %l %u [%{%d/%b/%Y:%H:%M:%S %z}t] "%r" %>s %b '
    '"%{Referer}i" "%{User-Agent}i" %I %O'
)
COMBINEDIO_STRFTIME_FIELDS = [
    "IP:connection.client.host",
    "TIME.EPOCH:request.receive.time.epoch",
    "TIME.YEAR:request.receive.time.year",
    "STRING:request.status.last",
    "BYTES:request.bytes",
    "BYTES:response.bytes",
]
ZONETEXT_FORMAT = '%h %l %u [%{%d/%b/%Y:%H:%M:%S %Z}t] "%r" %>s %b'
ZONETEXT_FIELDS = [
    "IP:connection.client.host",
    "TIME.EPOCH:request.receive.time.epoch",
    "TIME.HOUR:request.receive.time.hour_utc",
    "STRING:request.status.last",
]
# Zone names of the zone-text corpus, in turn: DST abbreviations, fixed
# zones and region ids, all in the device vocabulary.
ZONETEXT_ZONES = ["CET", "EST", "UTC", "Europe/Paris", "America/New_York",
                  "Asia/Tokyo", "PST", "GMT", "Australia/Sydney", "CEST"]


def combinedio_strftime_lines(n: int) -> List[str]:
    """Generated ``combined`` lines (seed 43, 1% garbage) with the %I and
    %O byte counts appended."""
    return [f"{ln} {100 + i} {5000 + i}" for i, ln in
            enumerate(generate_combined_lines(n, seed=43, garbage_fraction=0.01))]


def zonetext_lines(n: int) -> List[str]:
    """Generated ``combined`` lines (seed 48, 1% garbage) cut after %b, the
    numeric offset replaced by the zone names of ZONETEXT_ZONES in turn."""
    out = []
    for i, ln in enumerate(generate_combined_lines(n, seed=48, garbage_fraction=0.01)):
        try:
            ln = ln[:ln.rindex(' "', 0, ln.rindex(' "'))]
        except ValueError:
            pass
        out.append(re.sub(r"([+-]\d{4})\]", ZONETEXT_ZONES[i % len(ZONETEXT_ZONES)] + "]",
                          ln, count=1))
    return out


def strftime_edge_lines() -> List[str]:
    """Crafted lines for the two strftime configurations: the clock hour
    24 and 25, Feb 29 in a leap and a common year, second 60, offsets at
    and past +-24 h, %I / %O dashes and a 20-digit count; zone names that
    are not tokens of the vocabulary (UTCX, a region id in the wrong
    case), the CET DST gap and overlap, CEST in winter, 1969, a DST zone
    past its table (2040 CET) against a fixed one (2040 UTC), 2096 in a
    zone without DST, a zone token that ends the line, and garbage."""
    def io(ts: str, tail: str = "100 5000") -> str:
        return f'1.2.3.4 - - [{ts}] "GET /x HTTP/1.1" 200 5 "-" "u" {tail}'

    def zt(ts: str) -> str:
        return f'1.2.3.4 - - [{ts}] "GET /x HTTP/1.1" 200 5'

    return [
        io("01/Jan/2024:24:00:00 +0000"), io("01/Jan/2024:25:00:00 +0000"),
        io("01/Jan/2024:00:00:00 +0000"), io("29/Feb/2024:12:00:00 +0000"),
        io("29/Feb/2023:12:00:00 +0000"), io("31/Dec/2024:23:59:60 +0000"),
        io("01/Jan/2024:10:00:00 +2359"), io("01/Jan/2024:10:00:00 -2400"),
        io("01/Jan/2024:10:00:00 +24:00"), io("01/Jan/2024:10:00:00 +05:30"),
        io("01/jan/2024:10:00:00 -0930"), io("01/Jan/2024:10:00:00 UTC"),
        io("01/Jan/2024:10:00:00 +0000", "- -"),
        io("01/Jan/2024:10:00:00 +0000", "12345678901234567890 7"),
        zt("01/Jan/2024:24:00:00 UTC"), zt("01/Jan/2024:25:00:00 UTC"),
        zt("01/Jan/2024:10:00:00 UTCX"), zt("01/Jan/2024:10:00:00 europe/paris"),
        zt("01/Jan/2024:10:00:00 Europe/Paris"), zt("01/Jan/2024:10:00:00 utc"),
        zt("01/Jan/2024:10:00:00 CEST"), zt("31/Mar/2024:02:30:00 CET"),
        zt("27/Oct/2024:02:30:00 CET"), zt("31/Dec/1969:23:00:00 UTC"),
        zt("01/Jul/2040:10:00:00 CET"), zt("01/Jul/2040:10:00:00 UTC"),
        zt("01/Jul/2096:10:00:00 Asia/Kolkata"), zt("29/Feb/2096:10:00:00 Z"),
        zt("01/Jan/2024:10:00:00 America/Argentina/Buenos_Aires"),
        zt("01/Jan/2024:10:00:00 Mars/Olympus"), zt("01/Jan/2024:10:00:00 +0100"),
        zt("01/Jan/2024:10:00:00 ") + "]", "1.2.3.4 - - [01/Jan/2024:10:00:00 UTC",
        "1.2.3.4 - - [01/Jan/2024:10:00:00 Europe/Paris] garbage",
        "completely broken line", "",
    ]


# ---------------------------------------------------------------------------
# GeoIP enrichment: the reference package's bench.py ``geoip_chain``
# config, and the same fields over a synthetic City database of realistic
# size.
# ---------------------------------------------------------------------------

GEOIP_FIELDS = [
    "IP:connection.client.host",
    "STRING:connection.client.host.country.name",
    "STRING:connection.client.host.city.name",
    "ASN:connection.client.host.asn.number",
    "STRING:request.status.last",
]
# Addresses inside the fixture databases' 80.100.47.0/24 test range.
GEOIP_KNOWN_IPS = ["80.100.47.45", "80.100.47.1", "80.100.47.254", "80.100.47.13"]


def _set_host(line: str, host: str) -> str:
    return host + line[line.index(" "):] if " " in line else line


def geoip_chain_lines(n: int) -> List[str]:
    """Generated ``combined`` lines (seed 45, 1% garbage), every third
    host replaced by one of GEOIP_KNOWN_IPS in turn."""
    base = generate_combined_lines(n, seed=45, garbage_fraction=0.01)
    return [_set_host(ln, GEOIP_KNOWN_IPS[i % len(GEOIP_KNOWN_IPS)]) if i % 3 == 0 else ln
            for i, ln in enumerate(base)]


def geoip_synthetic_lines(n: int, networks) -> List[str]:
    """Generated ``combined`` lines (seed 46, 1% garbage) whose hosts are
    drawn (numpy, seed 46) half from inside ``networks`` (the sorted /24
    starts of the synthetic database: a network's first address, its last
    or one between, a third each) and half from outside them."""
    import numpy as np

    rng = np.random.default_rng(46)
    nets = np.asarray(networks, dtype=np.uint32)
    inside = nets[rng.integers(0, len(nets), size=n)].astype(np.int64)
    kind = rng.integers(0, 3, size=n)
    inside += np.where(kind == 0, 0, np.where(kind == 1, 255, rng.integers(1, 255, size=n)))
    taken = set((nets >> np.uint32(8)).tolist())
    outside = rng.integers(0, 1 << 32, size=2 * n + 64, dtype=np.int64)
    outside = outside[[int(a) >> 8 not in taken for a in outside]][:n]
    hosts = np.where(np.arange(n) % 2 == 0, inside, outside)
    base = generate_combined_lines(n, seed=46, garbage_fraction=0.01)
    return [_set_host(ln, ".".join(str((int(h) >> s) & 255) for s in (24, 16, 8, 0)))
            for ln, h in zip(base, hosts)]


def geoip_edge_lines() -> List[str]:
    """Crafted ``combined`` lines for the GeoIP paths: the fixture range's
    first and last address and its neighbours, 0.0.0.0, 255.255.255.255
    and 128.0.0.0 (negative as int32), leading zeros, an octet over 255,
    empty octets, three and five octets, a trailing dot, a port after the
    address (a ':' at byte 7, flagged; at byte 15, not), IPv6 literals
    (the host looks them up), a hostname, '-', and garbage."""
    def line(host: str) -> str:
        return f'{host} - - [01/Jan/2024:00:00:00 +0000] "GET /x HTTP/1.1" 200 5 "-" "u"'

    return [line(h) for h in GEOIP_EDGE_HOSTS] + ["completely broken line", ""]


GEOIP_EDGE_HOSTS = [
    "80.100.47.0", "80.100.47.255", "80.100.46.255", "80.100.48.0",
    "0.0.0.0", "255.255.255.255", "128.0.0.0", "080.100.47.1",
    "80.100.47.256", "80..47.1", "80.100.47", "80.100.47.1.2",
    "80.100.47.1.", "1.2.3.4:80", "123.123.123.123:8080",
    "2001:980::1", "::ffff:80.100.47.1", "example.com", "-",
    "80.100.47.001", "1234567890123456", ""]

# GeoIP groups over two IP tokens: NGINX's client and server addresses,
# City and ASN over each (four groups, two tokens).
GEOIP_TWO_TOKEN_FORMAT = "$remote_addr $server_addr $status"
GEOIP_TWO_TOKEN_FIELDS = [
    "IP:connection.client.host",
    "STRING:connection.client.host.country.name",
    "ASN:connection.client.host.asn.number",
    "STRING:connection.server.ip.city.name",
    "ASN:connection.server.ip.asn.number",
    "STRING:request.status.last",
]


def geoip_two_token_lines(n: int) -> List[str]:
    """n lines of GEOIP_TWO_TOKEN_FORMAT (numpy, seed 47): each address
    one of GEOIP_KNOWN_IPS, a random dotted quad or one of
    GEOIP_EDGE_HOSTS that holds no space, a third each; then every edge
    host (but the empty one) as client and as server address."""
    import numpy as np

    rng = np.random.default_rng(47)
    pool = [h for h in GEOIP_EDGE_HOSTS if h]

    def host() -> str:
        kind = int(rng.integers(0, 3))
        if kind == 0:
            return GEOIP_KNOWN_IPS[int(rng.integers(0, len(GEOIP_KNOWN_IPS)))]
        if kind == 1:
            return ".".join(str(int(o)) for o in rng.integers(0, 256, size=4))
        return pool[int(rng.integers(0, len(pool)))]

    lines = [f"{host()} {host()} {200 + int(rng.integers(0, 3))}" for _ in range(n)]
    return lines + [f"{h} 80.100.47.1 200" for h in pool] + [f"80.100.47.2 {h} 404"
                                                              for h in pool]


# ---------------------------------------------------------------------------
# NGINX: the reference package's bench.py ``nginx_uri`` config, and the
# latency / billing format NGINX sites log ($msec, $request_time).
# ---------------------------------------------------------------------------

NGINX_URI_FORMAT = ('$remote_addr - $remote_user [$time_local] "$request" $status '
                    '$body_bytes_sent "$http_referer" "$http_user_agent"')
NGINX_URI_FIELDS = [
    "IP:connection.client.host", "TIME.STAMP:request.receive.time",
    "HTTP.METHOD:request.firstline.method",
    "HTTP.PATH:request.firstline.uri.path",
    "HTTP.QUERYSTRING:request.firstline.uri.query",
    "STRING:request.status.last", "BYTES:response.body.bytes",
]
NGINX_TIMING_FORMAT = ('$remote_addr - $remote_user $msec "$request" $status '
                       '$body_bytes_sent "$http_referer" "$http_user_agent" $request_time')
NGINX_TIMING_FIELDS = [
    "IP:connection.client.host",
    "TIME.EPOCH:request.receive.time.epoch",
    "MILLISECONDS:response.server.processing.time",
    "MICROSECONDS:response.server.processing.time",
    "STRING:request.status.last",
    "HTTP.PATH:request.firstline.uri.path",
    "BYTES:response.body.bytes",
]


def _digits_bytes(line: str) -> str:
    """NGINX's $body_bytes_sent is digits: the CLF '-' becomes 0."""
    return re.sub(r'" (\d{3}) - ', r'" \1 0 ', line)


def nginx_uri_lines(n: int) -> List[str]:
    """Generated ``combined`` lines (seed 44, 1% garbage), byte counts
    as digits."""
    return [_digits_bytes(ln) for ln in generate_combined_lines(n, seed=44, garbage_fraction=0.01)]


def nginx_timing_lines(n: int) -> List[str]:
    """Generated ``combined`` lines (seed 49, 1% garbage), byte counts as
    digits, the ``[...]`` timestamp replaced by its epoch seconds and
    three seeded millisecond digits ($msec), and a seeded $request_time
    (0.000 to 9.999) appended."""
    import calendar

    rng = random.Random(49)
    out = []
    stamp = re.compile(r"\[(\d\d)/(\w\w\w)/(\d{4}):(\d\d):(\d\d):(\d\d) ([+-])(\d\d)(\d\d)\]")
    for ln in generate_combined_lines(n, seed=49, garbage_fraction=0.01):
        ln = _digits_bytes(ln)
        m = stamp.search(ln)
        if m:
            day, mon, year, hh, mm, ss, sign, oh, om = m.groups()
            offset = (int(oh) * 3600 + int(om) * 60) * (1 if sign == "+" else -1)
            epoch = calendar.timegm((int(year), _MONTHS.index(mon) + 1, int(day), int(hh),
                                     int(mm), int(ss))) - offset
            ln = f"{ln[:m.start()]}{epoch}.{rng.randint(0, 999):03d}{ln[m.end():]}"
            ln = f"{ln} {rng.randint(0, 9)}.{rng.randint(0, 999):03d}"
        out.append(ln)
    return out


def nginx_edge_lines() -> List[str]:
    """Crafted lines for both NGINX formats: $msec and $request_time
    values the device takes (15-digit seconds, 0.000) and those it sends
    to the host ('0.5', '12', a four-digit fraction, 20 digits, '-'), a
    '-' byte count and user, an IPv6 client, a referer with a space, and
    garbage."""
    def timing(msec: str = "1704067200.123", rt: str = "0.042", host: str = "1.2.3.4",
               size: str = "5", ref: str = "-") -> str:
        return (f'{host} - - {msec} "GET /p?a=1 HTTP/1.1" 200 {size} "{ref}" "u" {rt}')

    def uri(size: str = "5", ts: str = "01/Jan/2024:00:00:00 +0000", user: str = "-",
            ref: str = "-", req: str = "GET /p?a=1 HTTP/1.1") -> str:
        return f'1.2.3.4 - {user} [{ts}] "{req}" 200 {size} "{ref}" "u"'

    return [
        timing(), timing(rt="0.000"), timing(rt="0.5"), timing(rt="12"),
        timing(rt="12.345"), timing(rt="1.2345"), timing(rt="123456789012345.678"),
        timing(rt="1234567890123456.789"), timing(msec="000.000"),
        timing(msec="1704067200"), timing(msec="99999999999999999999.999"),
        timing(msec="-"), timing(rt="-"), timing(size="-"), timing(host="2001:980::1"),
        timing(ref="http://a b/"), timing(rt="7.5e3"),
        uri(), uri(size="-"), uri(user="bob"), uri(ts="01/jan/2024:00:00:00 -0930"),
        uri(ts="29/Feb/2023:00:00:00 +0000"), uri(ref="http://a b/"),
        uri(req="GET /a%20b?x=%zz&y HTTP/1.0"), uri(req="GET /x"),
        "completely broken line", "",
    ]


# The analytics pushdown's dashboard query (the reference bench's
# dashboard_spec): status mix, top endpoints, bytes served and their size
# histogram, traffic per hour, over HEADLINE_FIELDS.
DASHBOARD_OPS = [
    {"op": "count"},
    {"op": "count_by", "field": "STRING:request.status.last"},
    {"op": "top_k", "field": "HTTP.URI:request.firstline.uri", "k": 5},
    {"op": "sum", "field": "BYTES:response.body.bytes"},
    {"op": "histogram", "field": "BYTES:response.body.bytes",
     "edges": [1000, 100000, 10000000]},
    {"op": "time_bucket", "field": "TIME.EPOCH:request.receive.time.epoch",
     "width_s": 3600},
]


# The query-key lane (a count_by over one concrete query key) beside a
# span lane and a limbs lane summed and binned, over URI_CHAIN_FIELDS.
# Reached only through an AggregateSpec instance: validate_for refuses a
# count_by over a concrete query key (group "wild").
QUERY_KEY_OPS = [
    {"op": "count_by", "field": "STRING:request.firstline.uri.query.q"},
    {"op": "top_k", "field": "HTTP.PATH:request.firstline.uri.path", "k": 3},
    {"op": "sum", "field": "HTTP.PORT:request.referer.port"},
    {"op": "histogram", "field": "HTTP.PORT:request.referer.port", "edges": [-1, 80, 8080]},
]


def representative_spec(parser):
    """The reference bench's parity-sweep spec, derived from whatever the
    parser requests: count + count_by / top_k on the first string-group
    field + sum on the first numeric non-time field + an hourly
    time_bucket on the first epoch field (on the headline fields the
    string field is the client IP, nearly unique per line)."""
    from ..analytics.spec import parse_aggregate_config

    ops = [{"op": "count"}]
    str_f = num_f = ts_f = None
    for fid in parser.requested:
        plan = parser.plan_by_id.get(fid)
        if plan is None:
            continue
        group = parser._plan_group(plan)
        if str_f is None and group in ("span", "obj", "host"):
            str_f = fid
        if num_f is None and group == "numeric" and not fid.startswith("TIME."):
            num_f = fid
        if ts_f is None and fid.startswith("TIME.EPOCH:"):
            ts_f = fid
    if str_f is not None:
        ops.append({"op": "count_by", "field": str_f})
        ops.append({"op": "top_k", "field": str_f, "k": 5})
    if num_f is not None:
        ops.append({"op": "sum", "field": num_f})
    if ts_f is not None:
        ops.append({"op": "time_bucket", "field": ts_f, "width_s": 3600})
    return parse_aggregate_config(ops)


def aggregate_edge_lines() -> List[str]:
    """Crafted ``combined`` lines the aggregate must fold to the row path:
    a 20-digit byte count (Long overflow), a year-2050 timestamp (outside
    the device's 1902-2037 window), an escaped quote in the request (the
    row path sends it to the host) and in the user agent (decoded on the
    device), a %-repaired URI path and a '?&' query; plus a '-' byte
    count, an hour boundary and garbage."""
    def line(req: str = "GET /x HTTP/1.1", ts: str = "01/Jan/2026:10:00:00 +0000",
             size: str = "512", ua: str = "ua") -> str:
        return f'1.2.3.4 - - [{ts}] "{req}" 200 {size} "-" "{ua}"'

    return [
        line(size="9" * 20), line(ts="01/Jan/2050:00:00:00 +0000"),
        line(req='GET /p\\" HTTP/1.0'), line(ua='esc \\" quote'),
        line(req="GET /a%zzb/c?q=1 HTTP/1.1"), line(req="GET /s?&a=1 HTTP/1.1"),
        line(size="-"), line(ts="01/Jan/2026:10:59:59 +0000"),
        line(ts="01/Jan/2026:11:00:00 +0000"), line(ts="31/Dec/1969:23:59:59 +0000"),
        "completely broken line",
    ]


# Slice 6: request cookies, Set-Cookie and mod_unique_id.  Sites join
# access logs to sessions through the Cookie / Set-Cookie headers and to
# application logs through mod_unique_id's %{UNIQUE_ID}e.
COOKIE_FORMAT = ('%h %l %u %t "%r" %>s %b "%{Referer}i" "%{User-Agent}i" '
                 '"%{Cookie}i" "%{Set-Cookie}o" %{UNIQUE_ID}e')
COOKIE_REMAPPINGS = {"server.environment.unique_id": "MOD_UNIQUE_ID"}
COOKIE_FIELDS = [
    "IP:connection.client.host",
    "TIME.EPOCH:request.receive.time.epoch",
    "STRING:request.status.last",
    "HTTP.COOKIE:request.cookies.*",
    "HTTP.COOKIE:request.cookies.sid",
    "HTTP.SETCOOKIE:response.cookies.*",
    "HTTP.SETCOOKIE:response.cookies.sid",
    "STRING:response.cookies.sid.path",
    "TIME.EPOCH:response.cookies.sid.expires",
    "MOD_UNIQUE_ID:server.environment.unique_id",
    "TIME.EPOCH:server.environment.unique_id.epoch",
    "IP:server.environment.unique_id.ip",
    "PROCESSID:server.environment.unique_id.processid",
    "COUNTER:server.environment.unique_id.counter",
    "THREAD_INDEX:server.environment.unique_id.threadindex",
]
_COOKIE_NAMES = ["sid", "_ga", "_gid", "theme", "lang", "cart", "consent",
                 "ab_bucket", "csrftoken", "sessionid", "_fbp", "remember_me",
                 "currency", "tz", "locale", "cookie_notice", "PHPSESSID",
                 "JSESSIONID", "_hjid", "utm_source"]
_COOKIE_VALUE_BYTES = np.frombuffer(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789_.-",
    dtype=np.uint8)
_EXPIRES = "expires=Thu, 01-Jan-2027 00:00:00 GMT"


def _cookie_value(rng) -> str:
    """8 to 40 bytes; 5% hold a %XX escape or a '+'."""
    v = bytes(rng.choice(_COOKIE_VALUE_BYTES, size=int(rng.integers(8, 41)))).decode()
    if rng.random() < 0.05:
        at = int(rng.integers(0, len(v)))
        v = v[:at] + str(rng.choice(["%2F", "%3D", "%20", "%C3%A9", "+"])) + v[at + 3:]
    return v


def _unique_id(rng) -> str:
    """A mod_unique_id token: 32-bit seconds, IPv4, pid, 16-bit counter and
    32-bit thread index, base64 with '-' / '_' for '+' / '/'; 2% hold an
    '@' (which nothing decodes)."""
    raw = (int(rng.integers(1_700_000_000, 1_800_000_000)).to_bytes(4, "big")
           + bytes(rng.integers(1, 255, size=4, dtype=np.uint8).tolist())
           + int(rng.integers(1, 1 << 22)).to_bytes(4, "big")
           + int(rng.integers(0, 1 << 16)).to_bytes(2, "big")
           + int(rng.integers(0, 1 << 32)).to_bytes(4, "big"))
    token = base64.urlsafe_b64encode(raw).decode()
    if rng.random() < 0.02:
        at = int(rng.integers(0, 24))
        token = token[:at] + "@" + token[at + 1:]
    return token


def cookie_lines(n: int, seed: int = 50) -> List[str]:
    """``COOKIE_FORMAT`` lines: the generated ``combined`` lines (1%
    garbage, left as they are) with a Cookie header (10% '-', else 1 to 12
    cookies from 20 real names, values of 8 to 40 bytes), a Set-Cookie
    list (60% '-', else 1 to 3 cookies with ``path=/``, half of them with
    an ``expires=`` date holding ", ", some with ``domain=`` and
    ``HttpOnly``) and a UNIQUE_ID token, each from a numpy generator
    seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for ln in generate_combined_lines(n, seed=seed, garbage_fraction=0.01):
        if ln.count('"') != 6:
            out.append(ln)   # garbage
            continue
        if rng.random() < 0.1:
            cookie = "-"
        else:
            names = rng.choice(_COOKIE_NAMES, size=int(rng.integers(1, 13)))
            cookie = "; ".join(f"{name}={_cookie_value(rng)}" for name in names)
        if rng.random() < 0.6:
            setcookie = "-"
        else:
            parts = []
            for k in range(int(rng.integers(1, 4))):
                name = "sid" if k == 0 and rng.random() < 0.5 else str(rng.choice(_COOKIE_NAMES))
                part = f"{name}={_cookie_value(rng)}; path=/"
                if rng.random() < 0.5:
                    part += "; " + _EXPIRES
                if rng.random() < 0.3:
                    part += "; domain=.example.com"
                if rng.random() < 0.3:
                    part += "; HttpOnly"
                parts.append(part)
            setcookie = ", ".join(parts)
        out.append(f'{ln} "{cookie}" "{setcookie}" {_unique_id(rng)}')
    return out


def cookie_edge_lines() -> List[str]:
    """The reference's crafted values in ``COOKIE_FORMAT`` lines: Cookie
    headers (trimming, escapes, '-', 21 cookies), Set-Cookie lists (the
    expires rejoin, a held last part, the double hold and the
    ``set-cookie:`` prefix the host takes, 24 cookies: 16 -> 32 slots,
    the per-cookie attribute cases), mod_unique_id tokens (known decodes,
    the alphabet's ends, wrong lengths, '@', '+', '=', '-'), and a Cookie
    header past the 128-slot cap."""
    def line(cookie: str = "sid=abc123; theme=dark", setcookie: str = "sid=abc; path=/",
             uid: str = "VaGTKApid0AAALpaNo0AAAAC") -> str:
        return ('1.1.1.1 - - [07/Mar/2026:10:00:00 +0000] "GET /x HTTP/1.1" 200 5 '
                f'"-" "u" "{cookie}" "{setcookie}" {uid}')

    cookies = [
        "sid=abc123; theme=dark", "sid=x%20y; a=b+c", "-", "", "single",
        "sid=1;bad=nospace", "  sid = padded ; x=y", "sid=%u0041",
        "sid=%zz", "a=1; " * 20 + "z=2", "Name=Mixed; UP=1",
    ]
    setcookies = [
        "sid=abc; path=/", "sid=a, theme=b",
        "sid=1; expires=Thu, 01-Jan-2026 00:00:00 GMT; path=/, theme=d",
        "sid=1; Expires=Thu, 01 Jan 2026 00:00:00 GMT",
        "sid=1; expires=Thu, ", "x=expires=foo, y=2", "a=1, b=2, c=3",
        "a=x=y; path=/, b=2", "=nameless, b=2", " sid = padded , t=1",
        "-", "", "justaname", "UP=Mixed; Path=/",
        "sid=1; expires=Thu, 01-Jan-2026 00:00:00 GMT, "
        "t2=2; expires=Fri, 02-Jan-2026 00:00:00 GMT",
        "a=1; expires=Thu, b=2; expires=Fri, 03-Jan-2026 00:00:00 GMT",
        "set-cookie: sid=5; path=/", "Set-Cookie2: sid=6",
        "sid=abc; path=/; expires=Thu, 01-Jan-2026 00:00:00 GMT, t=1",
        ", ".join(f"c{i}={i}" for i in range(24)),
        "sid=abc; path=/shop; expires=Thu, 01-Jan-2027 00:00:00 GMT; "
        "domain=ex.com; comment=hi",
        "sid=plain", "sid=1; Expires=Thu, 01 Jan 2027 00:00:00 GMT",
        "sid=1; expires=Thu, 01 Jan 2027 00:00:00 GMT", "sid=1; expires=garbage",
        "other=1; path=/x", "sid=a; path=/1, sid=b; domain=d2", "sid=a; max-age=3600",
        "sid=v; path = /sp ; domain= d.e", "SID=case; path=/c",
    ]
    uids = [
        "VaGTKApid0AAALpaNo0AAAAC", "Ucdv38CoEJwAAEusp6EAAADz",
        "AAAAAAAAAAAAAAAAAAAAAAAA", "____________------------", "short",
        "VaGTKApid0AAALpaNo0AAA@C", "VaGTKApid0AAALpaNo0AAA+C",
        "VaGTKApid0AAALpaNo0AAA=C", "-",
    ]
    return ([line(cookie=c) for c in cookies] + [line(setcookie=c) for c in setcookies]
            + [line(uid=u) for u in uids]
            + [line(cookie="a=1; " * 130 + "z=2")])
