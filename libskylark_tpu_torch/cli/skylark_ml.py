"""skylark_ml: kernel-machine training/prediction via block-ADMM.

The port of libskylark_tpu/cli/skylark_ml.py (ref: ml/skylark_ml.cpp:
15-172 + ml/options.hpp): train mode builds a BlockADMMSolver from (loss,
regularizer, kernel) options on ``--device`` and saves a HilbertModel;
test mode loads a model and reports accuracy/error. Flags mirror the
reference's boost::program_options table (ml/options.hpp:116-197),
integer enums included. Model files are the JAX package's format: either
package loads the other's.

Example::

    python -m libskylark_tpu_torch.cli.skylark_ml train.libsvm model.json \\
        -l 2 -r 1 -k 1 -g 112 -c 0.01 -f 8192 -n 4 -e 0 --device cuda
    python -m libskylark_tpu_torch.cli.skylark_ml --testfile test.libsvm \\
        --modelfile model.json --device cuda
"""

from __future__ import annotations

import argparse
import sys
import time

# enums (ref: ml/options.hpp:26-52)
LOSSES = ["SQUARED", "LAD", "HINGE", "LOGISTIC"]
REGULARIZERS = ["NOREG", "L2", "L1"]
KERNELS = ["LINEAR", "GAUSSIAN", "POLYNOMIAL", "LAPLACIAN",
           "EXPSEMIGROUP", "MATERN"]


def build_parser() -> argparse.ArgumentParser:
    from libskylark_tpu_torch.cli import add_device_arg, add_streaming_args

    p = argparse.ArgumentParser(
        prog="skylark_ml",
        description="Block-ADMM kernel machines (ref: ml/skylark_ml.cpp)",
    )
    p.add_argument("trainfile", nargs="?", default="")
    p.add_argument("modelfile_pos", nargs="?", default="")
    p.add_argument("-l", "--lossfunction", type=int, default=0,
                   help="0:SQUARED 1:LAD 2:HINGE 3:LOGISTIC")
    p.add_argument("-r", "--regularizer", type=int, default=0,
                   help="0:None 1:L2 2:L1")
    p.add_argument("-k", "--kernel", type=int, default=0,
                   help="0:LINEAR 1:GAUSSIAN 2:POLYNOMIAL 3:LAPLACIAN "
                   "4:EXPSEMIGROUP 5:MATERN")
    p.add_argument("-g", "--kernelparam", type=float, default=1.0)
    p.add_argument("-x", "--kernelparam2", type=float, default=0.0)
    p.add_argument("-y", "--kernelparam3", type=float, default=1.0)
    p.add_argument("-c", "--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("-e", "--tolerance", type=float, default=0.001)
    p.add_argument("--rho", type=float, default=1.0)
    p.add_argument("-s", "--seed", type=int, default=12345)
    p.add_argument("-f", "--randomfeatures", type=int, default=0,
                   help="0 => exact linear features")
    p.add_argument("-n", "--numfeaturepartitions", type=int, default=1)
    p.add_argument("--regression", action="store_true")
    p.add_argument("--usefast", action="store_true")
    p.add_argument("-q", "--usequasi", type=int, default=0,
                   help="0: Monte Carlo, 1: leaped Halton (quasi)")
    p.add_argument("--cachetransforms", action="store_true")
    p.add_argument("--decisionvals", action="store_true")
    p.add_argument("--fileformat", type=int, default=0,
                   help="0 libsvm-dense, 1 libsvm-sparse, 2 hdf5-dense, "
                   "3 hdf5-sparse")
    p.add_argument("-i", "--MAXITER", type=int, default=10)
    add_streaming_args(p)
    p.add_argument("--modelfile", default="")
    p.add_argument("--valfile", default="")
    p.add_argument("--testfile", default="")
    p.add_argument("--outputfile", default="")
    p.add_argument("--checkpoint-dir", default="",
                   help="persist ADMM state here every "
                        "--checkpoint-every iterations; rerunning with "
                        "the same directory resumes (bit-identical to "
                        "an uninterrupted run)")
    p.add_argument("--checkpoint-every", type=int, default=10)
    add_device_arg(p)
    return p


def _make_kernel(args, d: int):
    from libskylark_tpu_torch.ml import kernels as K

    kp, kp2, kp3 = args.kernelparam, args.kernelparam2, args.kernelparam3
    kind = KERNELS[args.kernel]
    if kind == "LINEAR":
        return K.Linear(d)
    if kind == "GAUSSIAN":
        return K.Gaussian(d, sigma=kp)
    if kind == "POLYNOMIAL":
        return K.Polynomial(d, q=int(kp), c=kp2, gamma=kp3)
    if kind == "LAPLACIAN":
        return K.Laplacian(d, sigma=kp)
    if kind == "EXPSEMIGROUP":
        return K.ExpSemigroup(d, beta=kp)
    if kind == "MATERN":
        return K.Matern(d, nu=kp, l=kp2 or 1.0)
    raise SystemExit(f"unknown kernel {args.kernel}")


def _make_loss(args):
    from libskylark_tpu_torch.algorithms import prox

    return {
        "SQUARED": prox.SquaredLoss,
        "LAD": prox.LADLoss,
        "HINGE": prox.HingeLoss,
        "LOGISTIC": prox.LogisticLoss,
    }[LOSSES[args.lossfunction]]()


def _make_regularizer(args):
    from libskylark_tpu_torch.algorithms import prox

    return {
        "NOREG": prox.EmptyRegularizer,
        "L2": prox.L2Regularizer,
        "L1": prox.L1Regularizer,
    }[REGULARIZERS[args.regularizer]]()


def _dense(X, device):
    """A sparse operand densified on ``device`` (the ADMM solver and the
    model take dense rows, as the reference's do)."""
    return X.todense(device=device) if hasattr(X, "todense") else X


def _train(args) -> int:
    import numpy as np

    from libskylark_tpu_torch.base.context import Context
    from libskylark_tpu_torch.base.device import resolve_device
    from libskylark_tpu_torch.cli import read_dataset
    from libskylark_tpu_torch.ml.admm import BlockADMMSolver
    from libskylark_tpu_torch.parallel.mesh import to_host

    modelfile = args.modelfile or args.modelfile_pos
    if not modelfile:
        print("error: modelfile required", file=sys.stderr)
        return 2
    if args.streaming and args.fileformat != 0:
        print("error: --streaming supports fileformat 0 (libsvm-dense)",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    if args.streaming:
        from libskylark_tpu_torch.cli import read_streaming

        X, Y = read_streaming(args.trainfile, args.batch_rows, device)
    else:
        X, Y = read_dataset(args.trainfile, args.fileformat)
    d = X.shape[1]
    context = Context(seed=args.seed)
    loss = _make_loss(args)
    reg = _make_regularizer(args)

    if args.randomfeatures:
        kernel = _make_kernel(args, d)
        tag = "fast" if args.usefast else (
            "quasi" if args.usequasi else "regular")
        solver = BlockADMMSolver.from_kernel(
            context, loss, reg, args.lam, args.randomfeatures, kernel,
            tag=tag, num_partitions=args.numfeaturepartitions,
        )
    else:
        solver = BlockADMMSolver(
            loss, reg, args.lam, d,
            num_partitions=args.numfeaturepartitions,
        )
    solver.rho = args.rho
    solver.maxiter = args.MAXITER
    solver.tol = args.tolerance
    solver.cache_transforms = args.cachetransforms

    Xv = Yv = None
    if args.valfile:
        Xv, Yv = read_dataset(args.valfile, args.fileformat)

    Yn = to_host(Y)
    classes = None
    if not args.regression:
        # recode labels to 0..k-1 (the reference's coding layer); the
        # coding is stored in the model so predictions decode back
        classes = np.unique(Yn)
        Yn = np.searchsorted(classes, Yn)
        if Yv is not None:
            Yv = np.asarray(Yv)
            unknown = np.setdiff1d(np.unique(Yv), classes)
            if unknown.size:
                print(f"error: validation labels {unknown.tolist()} not in "
                      f"training labels", file=sys.stderr)
                return 2
            Yv = np.searchsorted(classes, Yv)

    t0 = time.time()
    model = solver.train(
        _dense(X, device), Yn,
        Xv=None if Xv is None else _dense(Xv, device),
        Yv=Yv, regression=args.regression, verbose=True,
        checkpoint=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every, device=device,
    )
    print(f"Training took {time.time() - t0:.2e} sec")
    if classes is not None:
        model.label_coding = classes.tolist()
    model.save(modelfile,
               header="trained by skylark_ml (libskylark_tpu_torch)")
    print(f"Model saved to {modelfile}")
    return 0


def _test(args) -> int:
    import numpy as np

    from libskylark_tpu_torch.base.device import resolve_device
    from libskylark_tpu_torch.cli import read_dataset
    from libskylark_tpu_torch.ml.metrics import classification_accuracy, rmse
    from libskylark_tpu_torch.ml.model import HilbertModel
    from libskylark_tpu_torch.parallel.mesh import to_host

    device = resolve_device(args.device)
    modelfile = args.modelfile or args.modelfile_pos
    model = HilbertModel.load(modelfile, device=device)
    X, Y = read_dataset(args.testfile, args.fileformat)
    labels, decisions = model.predict(_dense(X, device))
    labels = to_host(labels)
    Yn = np.asarray(Y)
    if not model.regression and model.num_outputs > 1:
        if model.label_coding is not None:
            # decode class indices back to the original training labels
            labels = np.asarray(model.label_coding)[labels.ravel()]
        else:
            # legacy model file without a stored coding: best effort —
            # recode the test labels to 0..k-1; only correct when the test
            # file contains exactly the training label set
            print("warning: model has no label coding; assuming the test "
                  "file's label set equals the training set", file=sys.stderr)
            Yn = np.searchsorted(np.unique(Yn), Yn)
    if args.outputfile:
        out = to_host(decisions) if args.decisionvals else labels
        np.savetxt(args.outputfile + ".txt", out, fmt="%.8g")
    if model.regression:
        print(f"RMSE = {rmse(labels, Yn):.6f}")
    else:
        print(f"Accuracy = {classification_accuracy(labels, Yn):.2f} %")
    return 0


def main(argv=None) -> int:
    from libskylark_tpu_torch.cli import honor_platform_env

    honor_platform_env()
    args = build_parser().parse_args(argv)
    if args.testfile:
        return _test(args)
    if not args.trainfile:
        print("error: trainfile required in training mode", file=sys.stderr)
        return 2
    return _train(args)


if __name__ == "__main__":
    sys.exit(main())
