"""``gcs_fake_server.GcsFakeServer`` with the JSON API's object ``DELETE``
(``DELETE /storage/v1/b/<bucket>/o/<object>``: 204, or 404 when the
object is absent), which ``GcsStore.delete`` speaks and the port's
checkpoint retention rides on. The base server is left as it is: this
subclass swaps in a request handler that adds the verb."""

from __future__ import annotations

import re
from urllib.parse import unquote, urlparse

from gcs_fake_server import GcsFakeServer

_OBJECT = re.compile(r"^/storage/v1/b/([^/]+)/o/(.+)$")


class GcsDeleteServer(GcsFakeServer):
    """``GcsFakeServer`` that also deletes objects; ``deletes`` counts the
    objects it removed."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.deletes = 0
        server = self
        base = self._httpd.RequestHandlerClass

        class Handler(base):
            def do_DELETE(self):
                if not self._gate():
                    return
                m = _OBJECT.match(urlparse(self.path).path)
                if not m:
                    return self._send(404)
                bucket, key = unquote(m.group(1)), unquote(m.group(2))
                with server.lock:
                    gone = server.objects.get(bucket, {}).pop(key, None)
                    server.deletes += gone is not None
                if gone is None:
                    return self._jsend(404, {"error": "notFound"})
                self._send(204)

        self._httpd.RequestHandlerClass = Handler
