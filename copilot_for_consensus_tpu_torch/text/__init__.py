"""Text plane: mbox parsing, normalization, thread building, draft
detection, chunking, tokenization.

Capability parity with the reference's parsing service internals
(``parsing/app/parser.py``, ``normalizer.py``, ``thread_builder.py``,
``draft_detector.py``) and the ``copilot_chunking`` adapter package
(SURVEY.md §2.1, §2.2).
"""
