"""Controller: worker registry, scheduling, heartbeat expiry, stream proxy;
the port's own copy of ``valley_tpu/serve/controller.py`` (standard
library and numpy; the proxy speaks through `httpd`'s urllib client).

Behavioral parity with `valley/serve/controller.py`: LOTTERY and
SHORTEST_QUEUE dispatch (`controller.py:28-39,120-169`), 15s worker
heartbeats expiring after 30s (`:51-54,183-191`), `/register_worker`,
`/refresh_all_workers`, `/list_models`, `/get_worker_address`,
`/receive_heart_beat`, `/worker_generate_stream` HTTP proxy with
error_code 2 (no worker) / 3 (worker timeout) (`:193-215`), and the
hierarchical controller-as-worker mode (`:218-236`).
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from valley_tpu_torch.constants import CONTROLLER_HEART_BEAT_EXPIRATION
from valley_tpu_torch.serve.httpd import (JsonHttpServer, iter_delimited,
                                          open_json, post_json)
from valley_tpu_torch.utils.logging import server_error_msg

logger = logging.getLogger("controller")


class DispatchMethod(enum.Enum):
    LOTTERY = enum.auto()
    SHORTEST_QUEUE = enum.auto()

    @classmethod
    def from_str(cls, name: str) -> "DispatchMethod":
        if name == "lottery":
            return cls.LOTTERY
        if name == "shortest_queue":
            return cls.SHORTEST_QUEUE
        raise ValueError(f"Invalid dispatch method: {name}")


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        self.worker_info: Dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod.from_str(dispatch_method)
        self._lock = threading.Lock()
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
        self._reaper.start()

    # -- registry --------------------------------------------------------

    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: Optional[dict]) -> bool:
        if worker_status is None:
            worker_status = self.get_worker_status(worker_name)
        if worker_status is None:
            return False
        with self._lock:
            self.worker_info[worker_name] = WorkerInfo(
                model_names=worker_status["model_names"],
                speed=worker_status["speed"],
                queue_length=worker_status["queue_length"],
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time())
        logger.info("Register done: %s, %s", worker_name, worker_status)
        return True

    def get_worker_status(self, worker_name: str) -> Optional[dict]:
        try:
            return post_json(worker_name + "/worker_get_status", {},
                             timeout=5)
        except Exception as e:
            logger.info("Get status fails: %s, %s", worker_name, e)
            return None

    def remove_worker(self, worker_name: str) -> None:
        with self._lock:
            self.worker_info.pop(worker_name, None)

    def refresh_all_workers(self) -> None:
        old_info = dict(self.worker_info)
        self.worker_info = {}
        for w_name, w_info in old_info.items():
            if not self.register_worker(w_name, w_info.check_heart_beat,
                                        None):
                logger.info("Remove stale worker: %s", w_name)

    def list_models(self) -> List[str]:
        names = set()
        for info in self.worker_info.values():
            names.update(info.model_names)
        return list(names)

    # -- scheduling ------------------------------------------------------

    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            candidates = [(n, i) for n, i in self.worker_info.items()
                          if model_name in i.model_names]
            if not candidates:
                return ""
            if self.dispatch_method == DispatchMethod.LOTTERY:
                speeds = np.array([i.speed for _, i in candidates],
                                  np.float32)
                norm = float(speeds.sum())
                if norm < 1e-4:
                    return ""
                idx = np.random.choice(len(candidates), p=speeds / norm)
                return candidates[idx][0]
            # shortest queue, speed-normalized
            qlens = [i.queue_length / i.speed for _, i in candidates]
            name = candidates[int(np.argmin(qlens))][0]
            self.worker_info[name].queue_length += 1
            logger.info("names: %s, queue_lens: %s, ret: %s",
                        [n for n, _ in candidates], qlens, name)
            return name

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            info = self.worker_info.get(worker_name)
            if info is None:
                logger.info("Receive unknown heart beat. %s", worker_name)
                return False
            info.queue_length = queue_length
            info.last_heart_beat = time.time()
        return True

    def _reap_loop(self):
        while True:
            time.sleep(CONTROLLER_HEART_BEAT_EXPIRATION)
            self.remove_stale_workers_by_expiration()

    def remove_stale_workers_by_expiration(self) -> None:
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        dead = [n for n, i in self.worker_info.items()
                if i.check_heart_beat and i.last_heart_beat < expire]
        for name in dead:
            self.remove_worker(name)

    # -- proxy -----------------------------------------------------------

    def worker_api_generate_stream(self, params: dict):
        worker_addr = self.get_worker_address(params["model"])
        if not worker_addr:
            logger.info("no worker: %s", params["model"])
            yield json.dumps({"text": server_error_msg,
                              "error_code": 2}).encode() + b"\0"
            return
        try:
            with open_json(worker_addr + "/worker_generate_stream", params,
                           timeout=60) as response:
                for chunk in iter_delimited(response):
                    yield chunk + b"\0"
        except OSError:    # URLError, HTTPError, timeouts, resets
            logger.info("worker timeout: %s", worker_addr)
            yield json.dumps({"text": server_error_msg,
                              "error_code": 3}).encode() + b"\0"

    # hierarchical mode: the controller reports as one aggregate worker
    def worker_api_get_status(self) -> dict:
        model_names, speed, queue_length = set(), 0.0, 0
        for name in list(self.worker_info):
            status = self.get_worker_status(name)
            if status is not None:
                model_names.update(status["model_names"])
                speed += status["speed"]
                queue_length += status["queue_length"]
        return {"model_names": list(model_names), "speed": speed,
                "queue_length": queue_length}


def build_app(controller: Controller) -> JsonHttpServer:
    app = JsonHttpServer()

    @app.post("/register_worker")
    def register_worker(data):
        controller.register_worker(
            data["worker_name"], data["check_heart_beat"],
            data.get("worker_status"))
        return {}

    @app.post("/refresh_all_workers")
    def refresh_all_workers(_data):
        controller.refresh_all_workers()
        return {}

    @app.post("/list_models")
    def list_models(_data):
        return {"models": controller.list_models()}

    @app.post("/get_worker_address")
    def get_worker_address(data):
        return {"address": controller.get_worker_address(data["model"])}

    @app.post("/receive_heart_beat")
    def receive_heart_beat(data):
        exist = controller.receive_heart_beat(
            data["worker_name"], data["queue_length"])
        return {"exist": exist}

    @app.post("/worker_generate_stream")
    def worker_generate_stream(data):
        return controller.worker_api_generate_stream(data)

    @app.post("/worker_get_status")
    def worker_get_status(_data):
        return controller.worker_api_get_status()

    return app


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=21001)
    parser.add_argument("--dispatch-method", type=str,
                        choices=["lottery", "shortest_queue"],
                        default="shortest_queue")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    controller = Controller(args.dispatch_method)
    app = build_app(controller)
    app.host, app._port = args.host, args.port
    app.serve_forever()


if __name__ == "__main__":
    main()
