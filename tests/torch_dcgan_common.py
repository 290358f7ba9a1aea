"""Shared pieces of the DCGAN tests: the model of Radford, Metz and
Chintala (arXiv:1511.06434, section 3 and figure 1) built of public layers,
the same in both packages, and one training iteration.  The JAX package
has no GAN class, so neither does the port: the model lives here and in
``chip_smoke.py`` (``dcgan_models``).  Weights and BatchNorm buffers carry
from the reference to the port by name (``models.load_named_params``,
``load_named_buffers``).

- G: z (B, 100, 1, 1) -> ``Conv2DTranspose(100, 8 ngf, 4, 1, 0)`` (the
  project-and-reshape to 4 x 4), then ``Conv2DTranspose(k4, s2, p1)`` to
  4 ngf, 2 ngf, ngf and 3 channels; ``BatchNorm2D`` + ReLU after each but
  the last, Tanh after it: (B, 3, 64, 64).
- D: the mirror, ``Conv2D(k4, s2, p1)`` 3 -> ndf -> 2 ndf -> 4 ndf -> 8 ndf
  with ``LeakyReLU(0.2)`` after each and ``BatchNorm2D`` after all but the
  first, then ``Conv2D(8 ndf, 1, 4)``: one logit a sample.
- Every convolution's weight is N(0, 0.02) (``ParamAttr`` +
  ``nn.initializer.Normal``); a convolution that a BatchNorm follows has
  no bias.  The published widths are ngf = ndf = 128 (1024 channels at
  4 x 4).
- An iteration: ``fake = G(z)``; one D step on ``d_loss``; one G step on
  ``g_loss`` over the same ``fake`` (``Adam(2e-4, beta1=0.5)`` each)."""
Z_DIM = 100


def _attr(nn):
    return nn.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))


def generator(nn, ngf, **kw):
    widths = [8 * ngf, 4 * ngf, 2 * ngf, ngf]
    layers = [nn.Conv2DTranspose(Z_DIM, widths[0], 4, 1, 0,
                                 weight_attr=_attr(nn), bias_attr=False,
                                 **kw),
              nn.BatchNorm2D(widths[0], **kw), nn.ReLU()]
    for cin, cout in zip(widths, widths[1:]):
        layers += [nn.Conv2DTranspose(cin, cout, 4, 2, 1,
                                      weight_attr=_attr(nn), bias_attr=False,
                                      **kw),
                   nn.BatchNorm2D(cout, **kw), nn.ReLU()]
    layers += [nn.Conv2DTranspose(ngf, 3, 4, 2, 1, weight_attr=_attr(nn),
                                  **kw), nn.Tanh()]
    return nn.Sequential(*layers)


def discriminator(nn, ndf, **kw):
    widths = [ndf, 2 * ndf, 4 * ndf, 8 * ndf]
    layers = [nn.Conv2D(3, ndf, 4, 2, 1, weight_attr=_attr(nn), **kw),
              nn.LeakyReLU(0.2)]
    for cin, cout in zip(widths, widths[1:]):
        layers += [nn.Conv2D(cin, cout, 4, 2, 1, weight_attr=_attr(nn),
                             bias_attr=False, **kw),
                   nn.BatchNorm2D(cout, **kw), nn.LeakyReLU(0.2)]
    layers.append(nn.Conv2D(8 * ndf, 1, 4, weight_attr=_attr(nn), **kw))
    return nn.Sequential(*layers)


def d_loss(loss_fn, d, real, fake, ones, zeros):
    """D's loss on a real batch and on G's images ``fake``, G held (the
    images detached)."""
    return loss_fn(d(real), ones) + loss_fn(d(fake.detach()), zeros)


def g_loss(loss_fn, d, fake, ones):
    """G's loss: D's verdict on the same images against the real label."""
    return loss_fn(d(fake), ones)
