"""Evaluation of the port: its own copies of the numpy / pure-Python
``vlp3d/eval/`` modules ``box_iou``, ``grounding``, ``detection`` (NMS,
``parse_predictions``, ``APCalculator``), ``capeval`` and ``meteor``
(BLEU, CIDEr, ROUGE-L, METEOR 1.5 without its optional synonym and
paraphrase tables) and ``captioning`` (the Scan2Cap candidates and
scores)."""
