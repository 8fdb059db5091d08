"""Localhost TCP diagnostics admin server (reference
diagnostics_server.h:14,129 + the concord-ctl CLI). Line protocol:

  status list            -> registered status handler names
  status get <name>      -> handler output
  perf list              -> histogram names
  perf show <name>       -> count/avg/p50/p95/p99/max
  quit
"""
from __future__ import annotations

import json
import socket
import threading
from typing import Optional

from tpubft_torch.diagnostics.registrar import Registrar, get_registrar


class DiagnosticsServer:
    def __init__(self, registrar: Optional[Registrar] = None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self._reg = registrar or get_registrar()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._running = False

    def start(self) -> None:
        self._running = True
        self._sock.listen(4)
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"diag-{self.port}").start()

    def stop(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            fh = conn.makefile("rw", encoding="utf-8", newline="\n")
            for line in fh:
                reply = self._handle(line.strip())
                if reply is None:
                    break
                fh.write(reply + "\n.\n")
                fh.flush()
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, line: str) -> Optional[str]:
        parts = line.split()
        if not parts or parts[0] == "quit":
            return None
        if parts[0] == "status":
            if len(parts) == 2 and parts[1] == "list":
                return "\n".join(self._reg.status_keys()) or "(none)"
            if len(parts) == 3 and parts[1] == "get":
                return self._reg.get_status(parts[2])
        if parts[0] == "perf":
            if len(parts) == 2 and parts[1] == "list":
                return "\n".join(self._reg.histogram_keys()) or "(none)"
            if len(parts) == 3 and parts[1] == "show":
                snap = self._reg.histogram_snapshot(parts[2])
                return (json.dumps(snap) if snap is not None
                        else f"unknown histogram: {parts[2]}")
        return f"bad command: {line!r} (try: status list | status get X | " \
               f"perf list | perf show X | quit)"
