"""A fake Kubernetes API server on 127.0.0.1, for the tests and the chip
script's `k8s` phase (not a feature of the scanner).

    api = FakeKubeAPI(routes, node_infos, token="t")
    base = api.start()                 # http://127.0.0.1:PORT
    cfg = api.write_kubeconfig(path)   # a kubeconfig naming it
    ...
    api.stop()

`routes` maps a GET path (its query string ignored) to the JSON document
served there, so an absent API group answers 404, as an old cluster's
does. A request without `Authorization: Bearer <token>` answers 401
when a token is set. The node collector's calls behave as a cluster
whose Jobs finish at once: POSTing a Job records it and makes its pod,
labelled `job-name=<job>`, already `Succeeded`, so the collector's poll
never sleeps; that pod's log is the NodeInfo document of the node the
Job is pinned to (`node_infos[node]`; a str is served as it is, as
from a collector whose output does not parse), and DELETE records the
Job's name in `deleted`."""

from __future__ import annotations

import json
import threading
import urllib.parse

import yaml

from ..fanal.fixtures import _Handler, _LoopbackServer


class _KubeHandler(_Handler):
    def _json(self, doc, code: int = 200) -> None:
        self._reply(code, json.dumps(doc).encode(), "application/json")

    def _authed(self) -> bool:
        api = self.server.fake
        api.record(self.command, self.path)
        if api.token and self.headers.get("Authorization") != \
                f"Bearer {api.token}":
            self._json({"kind": "Status", "code": 401,
                        "reason": "Unauthorized"}, 401)
            return False
        return True

    def do_GET(self):
        if not self._authed():
            return
        api = self.server.fake
        path, _, query = self.path.partition("?")
        selector = urllib.parse.parse_qs(query).get("labelSelector", [""])[0]
        if selector.startswith("job-name="):
            job = selector.split("=", 1)[1]
            with api.lock:
                known = job in api.jobs
            self._json({"items": [{
                "metadata": {"name": f"{job}-pod",
                             "labels": {"job-name": job}},
                "status": {"phase": "Succeeded"}}] if known else []})
            return
        if path.endswith("/log") and "/pods/" in path:
            job = path.split("/pods/")[1].split("/")[0][:-len("-pod")]
            with api.lock:
                manifest = api.jobs.get(job)
            if manifest is None:
                return self._json({"code": 404}, 404)
            info = api.node_infos[
                manifest["spec"]["template"]["spec"]["nodeName"]]
            self._reply(200, info.encode() if isinstance(info, str)
                        else json.dumps(info).encode(), "text/plain")
            return
        doc = api.routes.get(path)
        if doc is None:
            return self._json({"kind": "Status", "code": 404}, 404)
        self._json(doc)

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if not self._authed():
            return
        doc = json.loads(body)
        with self.server.fake.lock:
            self.server.fake.jobs[doc["metadata"]["name"]] = doc
        self._json(doc, 201)

    def do_DELETE(self):
        if not self._authed():
            return
        name = self.path.split("/jobs/")[1].split("?")[0]
        api = self.server.fake
        with api.lock:
            api.deleted.append(name)
            api.jobs.pop(name, None)
        self._json({"kind": "Status", "status": "Success"})


class FakeKubeAPI(_LoopbackServer):
    """The canned cluster (module docstring); `requests` lists each
    (method, path) it was asked, `jobs` the collector Jobs still
    standing, `deleted` the ones removed."""

    _handler = _KubeHandler

    def __init__(self, routes: dict, node_infos: dict | None = None,
                 token: str = ""):
        self.routes = routes
        self.node_infos = node_infos or {}
        self.token = token
        self.lock = threading.Lock()
        self.jobs: dict = {}
        self.deleted: list = []
        self.requests: list = []

    def record(self, method: str, path: str) -> None:
        with self.lock:
            self.requests.append((method, path))

    def write_kubeconfig(self, path: str, namespace: str = "") -> str:
        """A kubeconfig whose current context names this server and its
        token → `path`."""
        context = {"cluster": "fake", "user": "fake"}
        if namespace:
            context["namespace"] = namespace
        doc = {"apiVersion": "v1", "kind": "Config",
               "current-context": "fake",
               "contexts": [{"name": "fake", "context": context}],
               "clusters": [{"name": "fake", "cluster": {
                   "server": f"http://127.0.0.1:{self.port}"}}],
               "users": [{"name": "fake", "user": {"token": self.token}
                          if self.token else {}}]}
        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(doc, f)
        return path
