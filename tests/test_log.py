"""Log tests — port of tests/engine/log_test.cpp: severity routing into
injected streams, [file:line] preamble format, and multi-part printing."""

import io
import re
import threading

from vktf.log import Log, Severity, default_log


def make_log():
    out, err = io.StringIO(), io.StringIO()
    return Log(out_stream=out, err_stream=err), out, err


def test_info_routes_to_out_stream():
    log, out, err = make_log()
    log.info("hello", 42)
    assert "hello 42" in out.getvalue()
    assert err.getvalue() == ""


def test_warn_and_error_route_to_err_stream():
    log, out, err = make_log()
    log.warn("w")
    log.error("e")
    assert out.getvalue() == ""
    lines = err.getvalue().strip().splitlines()
    assert "WARNING: w" in lines[0]
    assert "ERROR: e" in lines[1]


def test_preamble_has_file_and_line():
    log, out, _ = make_log()
    log.info("x")
    assert re.match(r"^\[test_log\.py:\d+\] INFO: x$", out.getvalue().strip())


def test_print_with_explicit_severity():
    log, out, err = make_log()
    log.print(Severity.ERROR, "boom")
    assert "ERROR: boom" in err.getvalue()
    assert out.getvalue() == ""


def test_thread_safety_whole_lines():
    log, out, _ = make_log()

    def worker(tag):
        for _ in range(50):
            log.info(tag * 8)

    threads = [threading.Thread(target=worker, args=(t,)) for t in "abcd"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 200
    for line in lines:
        body = line.split("INFO: ")[1]
        assert len(set(body)) == 1  # no interleaving within a line


def test_default_log_singleton():
    assert default_log() is default_log()
