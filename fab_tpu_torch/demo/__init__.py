"""The port's demos (``demo/`` of the repository): FAB against reverse KL on GMM-40
and ManyWell-6, the ALDP Ramachandran demo, and the generator of this folder's
notebooks.

    python3 -m fab_tpu_torch.demo.many_well_demo [--iters 500] [--device cpu]
"""
