"""The paper's section-5 experiments on the port (``repro.experiments``):
``convex`` (5.1, SGD and SVRG on logistic regression), ``cnn`` (5.2) and
``conflicts`` (5.3, the shared-memory SVM write-conflict model). Each entry
point runs on the card unless the caller passes ``device="cpu"``; M
workers are simulated in one process, their messages compressed as one
``[M, d]`` batch (one launch per kernel), and every random draw comes from
an explicit ``torch.Generator`` seeded by ``seed``."""
