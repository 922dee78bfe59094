"""wandb metric mirror (solver_3dvlp.py:531-565, train_3dvlp.py:790-794).

The port's own copy of ``vlp3d/utils/wandb_writer.py``.

The reference logs every train/val series to wandb with phase-prefixed
keys ("train_loss", "val_iou_rate_0.5", ...) plus "epoch"/"iter" step
metrics. When `import wandb` (or its init) fails, as it does without the
package or without a network, the writer degrades to an offline JSONL
stream with the same record shape (<workdir>/wandb_offline.jsonl) that
`wandb sync`-style tooling — or any log reader — can consume later.
"""

from __future__ import annotations

import json
import os
import time


class WandbWriter:
    def __init__(
        self,
        workdir: str,
        *,
        project: str = "3dvlp",
        entity: str | None = None,
        name: str | None = None,
        config: dict | None = None,
        enabled: bool = True,
    ):
        self.enabled = enabled
        self._run = None
        self._f = None
        if not enabled:
            return
        try:
            import wandb

            self._run = wandb.init(
                project=project, entity=entity, name=name, config=config,
                dir=workdir,
            )
            # epoch/iter step metrics (train_3dvlp.py:791-794)
            wandb.define_metric("epoch")
            wandb.define_metric("epoch/*", step_metric="epoch")
            wandb.define_metric("iter")
            wandb.define_metric("iter/*", step_metric="iter")
        except Exception:
            os.makedirs(workdir, exist_ok=True)
            self._f = open(
                os.path.join(workdir, "wandb_offline.jsonl"), "a"
            )
            if config is not None:
                self._f.write(
                    json.dumps({"_type": "config", "config": config},
                               default=str) + "\n"
                )

    def log(self, record: dict, step: int | None = None) -> None:
        if not self.enabled:
            return
        if self._run is not None:
            self._run.log(record, step=step)
            return
        out = {"_time": time.time(), **record}
        if step is not None:
            out["_step"] = step
        self._f.write(json.dumps(out, default=float) + "\n")
        self._f.flush()

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
        elif self._f is not None:
            self._f.close()
